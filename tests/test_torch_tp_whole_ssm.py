"""Prompts and caches that do not divide the "model" axis in the recurrent
families (``tests/torch_tp_whole_worker.py``'s ``ssm`` job): zamba2-reduced
(Mamba2 and its shared attention and MLP blocks) and RWKV6 on (1, 3), a
prompt of 10 and a cache of 14 (every block whole on every rank, its
leaves counted once in the gradients), and on (2, 2) with fsdp, 9 and 13
(Mamba2 on the rank's head, its part summed over the axis in float32;
``rwkv6-heads4`` on the rank's 2 heads, the output's columns gathered);
the states split by heads where they divide, the convolution history and
``x_prev`` whole. The train check runs twice (float32 logits; bf16 with
the logit gradients' measured flips as a floor) and zamba2's logits are
held by the float64 rule (ROADMAP.md queue 3). Bounds: the worker's."""
import pytest

torch = pytest.importorskip("torch")

import torch_tp_whole_worker as worker  # noqa: E402
from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_whole import check_job  # noqa: E402


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)], ids=["1x3-alike", "2x2-fsdp-heads"])
def test_recurrent_families_on_whole_rows_equal_one_process(shape, tmp_path):
    worst = check_job("ssm", shape, tmp_path)
    for name in worker.JOBS["ssm"][shape]:
        assert f"{name}/train_bf16_logits/params_beyond_tol_over_lr" in worst
    assert worst["zamba2-1.2b/prefill_logits_of_float64_bound"] <= 1.0
