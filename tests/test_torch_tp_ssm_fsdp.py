"""The recurrent families over a "model" axis of 2 with two data ranks:
``test_torch_tp_ssm.py``'s mesh check on (data, model) = (2, 2), where
every config trains with fsdp (each leaf stored as its data rank's shard
of the rank's "model" shard, gathered per layer; zamba2's shared blocks
gathered in every period) and each data rank prefills and decodes its own
rows. Bounds: the workers' (``tests/torch_tp_ssm_worker.py``,
``tests/torch_tp_attn_worker.py``)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_ssm import check_mesh  # noqa: E402


def test_recurrent_families_on_a_2x2_fsdp_mesh_equal_one_process(tmp_path):
    worst = check_mesh((2, 2), tmp_path)
    assert worst["zamba2-1.2b/train/gradients_vs_one"] > 0  # both data ranks' rows
