"""Prompts and caches that do not divide the "model" axis in the MoE family
(``tests/torch_tp_whole_worker.py``'s ``moe`` job): granite-reduced (MoE)
and deepseek-reduced (MLA, its latent and rope-key caches whole; its MoE
with shared experts) on (1, 3), a prompt of 10 and a cache of 14 (the MoE
replicated, every rank computing the block alike: its leaves counted once
in the gradients), and on (2, 2) with fsdp, 9 and 13 (ffn- or
expert-parallel parts entering by ``to_parts``, summed over the axis).
Bounds: the worker's."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_whole import check_job  # noqa: E402


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)], ids=["1x3-alike", "2x2-fsdp-parts"])
def test_moe_on_whole_rows_equals_one_process(shape, tmp_path):
    worst = check_job("moe", shape, tmp_path)
    assert (worst["deepseek-v2-lite-16b/init_split_leaves"] == 0) == (shape == (1, 3))
