"""The attention variants over a "model" axis of 2 with two data ranks:
``test_torch_tp_attn.py``'s mesh check on (data, model) = (2, 2), where
deepseek-reduced and qwen2-vl-reduced train with fsdp (the reference's
``TRAIN_OVERRIDES``: each leaf stored as its data rank's shard of the
rank's "model" shard, gathered per layer) and every arch's caches, MoE
capacity and load-balance loss are per data rank. Bounds: the worker's
(``tests/torch_tp_attn_worker.py``)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_attn import check_mesh  # noqa: E402


def test_attention_variants_on_a_2x2_fsdp_mesh_equal_one_process(tmp_path):
    worst = check_mesh((2, 2), tmp_path)
    assert worst["deepseek-v2-lite-16b/train/gradients_vs_one"] > 0  # both data ranks' rows
