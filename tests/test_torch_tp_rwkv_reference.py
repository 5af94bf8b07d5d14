"""RWKV6 over a "model" mesh axis above 1 against the JAX reference on one
device: rwkv6-reduced (one head of 64: over 2 ranks its columns split in
halves, the leaves gathered and the block run whole; the channel mix's
d_ff split) and its copy with 4 heads of 16 (2 a rank over 2: the scan on
the rank's heads, the columns-to-rows all-to-all), in float32 on gloo
meshes (data, model) = (1, 2) and (1, 3), with
``test_torch_tp_ssm_reference.py``'s reference run (its ``mu_*``, ``u``
and ``w0`` redrawn) and bounds: logits within one bf16 ulp + 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_ssm_reference import check_against_reference, reference_pickle_of  # noqa: E402

NAMES = ("rwkv6-7b", "rwkv6-heads4")


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    return reference_pickle_of(NAMES, tmp_path_factory.mktemp("tp_rwkv_ref") / "ref.pkl")


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2-heads", "1x3-whole"])
def test_rwkv6_matches_the_reference_on_a_mesh(shape, tmp_path, reference_pickle):
    check_against_reference(shape, tmp_path, reference_pickle, NAMES)
