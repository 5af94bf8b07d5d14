"""Prompts and caches that do not divide the "model" axis on (data, model)
= (2, 2) with fsdp (``tests/torch_tp_whole_worker.py``'s ``fsdp`` job): a
prompt of 9 and a cache of 13 over 2 ranks. internlm2-, qwen2-vl- and
gemma3-reduced run head-parallel on whole rows (the block input entering
the rank's heads by ``to_parts``, the parts all-reduced in float32, the
norms counted once in the gradients), each leaf stored as its data rank's
shard and gathered per layer; gemma3's 8-slot rings split over the ranks'
slots beside its full caches of 13, whole: a mixed layout, each layer
decoding in its own. Bounds: the worker's."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_whole import check_job  # noqa: E402


def test_whole_rows_on_a_2x2_fsdp_mesh_equal_one_process(tmp_path):
    worst = check_job("fsdp", (2, 2), tmp_path)
    assert worst["gemma3-1b/init_split_leaves"] > 0
    assert worst["qwen2-vl-72b/train/gradients_vs_one"] > 0  # both data ranks' rows
