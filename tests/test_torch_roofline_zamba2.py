"""The dot FLOPs of zamba2's built train, prefill and decode steps (Mamba2
blocks and the shared attention and MLP) against the reference's
``analyze_hlo_text`` of the same functions (``torch_roofline_ref``): the
forward steps equal, the train step short by ``expected_gap`` (one
product of the backward pass a Mamba2 block, a dot in XLA's HLO).
"""
import pytest

torch = pytest.importorskip("torch")

from torch_roofline_ref import KINDS, expected_gap, port_flops, ref_flops


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
def test_zamba2_dot_flops_match_reference(kind):
    pytest.importorskip("jax")
    gap = expected_gap("zamba2-1.2b", kind)
    assert (gap > 0) == (kind == "train")
    assert port_flops("zamba2-1.2b", kind) == ref_flops("zamba2-1.2b", kind) - gap
