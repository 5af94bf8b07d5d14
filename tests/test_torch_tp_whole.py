"""Prompts and caches that do not divide the "model" mesh axis, in the
decoder-only families (the dense job of ``tests/torch_tp_whole_worker.py``;
the other jobs: ``test_torch_tp_whole_fsdp.py``, ``_moe.py``, ``_ssm.py``,
``_reference.py``), on gloo meshes of CPU processes, float32:

* (1, 3), a prompt of 10 and a cache of 14: internlm2-, qwen2-vl- and
  gemma3-reduced run every block alike on every rank (their leaves counted
  once in the gradients: the worker checks that the train check fails
  where they count on every rank); ``dense-straddle``, 6 heads over 2 kv
  heads, head-parallel on whole rows, rank 1's query heads straddling the
  whole cache's kv heads 0 and 1;
* (1, 4), the same lengths: internlm2- and phi4-mini-reduced, one query
  head a rank over kv head r // 2 of the whole cache.

Each case holds the init, one train step, the prefill and 3 decode steps
to the port in one process with the dense tensor-parallel tests' bounds
(the worker's docstring). In one process: the decode over a whole cache of
several kv heads, split into the ranks' query heads (one call per kv head
they read, on its strided slice of the cache), equals the decode of every
head; the kv heads each rank reads; the cache layouts of the reference's
spec.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.sharding_hooks import TP, cache_layout  # noqa: E402

import torch_tp_whole_worker as worker  # noqa: E402
from test_torch_tp import one_torch_thread  # noqa: E402,F401


def spawn_job(job, shape, tmp_path, ref_path=None):
    """``worker.run`` of ``job`` on a gloo mesh of ``shape``; the worst of
    the ranks' gaps by key."""
    world = shape[0] * shape[1]
    mp.start_processes(worker.run, args=(world, shape, str(tmp_path), job, ref_path),
                       nprocs=world, join=True, start_method="spawn")
    gaps = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    print(f"{job} on {shape}: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    return worst


def check_job(job, shape, tmp_path):
    """One spawn of ``job`` on ``shape``: every case's keys present."""
    worst = spawn_job(job, shape, tmp_path)
    for name in worker.JOBS[job][shape]:
        assert f"{name}/decode_cache_vs_float64" in worst
        assert f"{name}/train/params_beyond_tol_over_lr" in worst
    return worst


@pytest.mark.parametrize("shape", [(1, 3), (1, 4)], ids=["1x3-alike-and-straddle",
                                                         "1x4-one-kv-head"])
def test_whole_rows_and_caches_equal_one_process(shape, tmp_path):
    worst = check_job("dense", shape, tmp_path)
    if shape == (1, 3):
        assert worst["internlm2-1.8b/counted_on_every_rank_fails"] == 1
        assert worst["internlm2-1.8b/init_split_leaves"] == 0
        assert worst["dense-straddle/init_split_leaves"] > 0  # heads and ffn split over 3
    else:
        assert worst["internlm2-1.8b/init_split_leaves"] > 0


@pytest.mark.parametrize("M,want", [
    (16, [[(r // 2, slice(0, 1))] for r in range(16)]),  # internlm2-1.8b: 16 heads, 8 kv
    (12, None),                                          # phi4-mini-3.8b: 24 heads, 8 kv
])
def test_whole_cache_groups(M, want):
    """The kv heads each rank's query heads read of a whole cache: one for
    internlm2-1.8b at M = 16; at M = 12 phi4-mini-3.8b's ranks 1, 4, 7 and
    10 straddle two (24 heads over 8 kv heads, 2 a rank)."""
    H, KV = (16, 8) if M == 16 else (24, 8)
    Hl = H // M
    got = [L.whole_cache_groups(r * Hl, Hl, H // KV) for r in range(M)]
    if want is not None:
        assert got == want
        return
    straddle = [r for r, g in enumerate(got) if len(g) > 1]
    assert straddle == [1, 4, 7, 10]
    assert got[1] == [(0, slice(0, 1)), (1, slice(1, 2))]
    for r, groups in enumerate(got):  # every head once, in order, of its own kv head
        heads = [r * Hl + i for g, hs in groups for i in range(hs.start, hs.stop)]
        assert heads == list(range(r * Hl, (r + 1) * Hl))
        assert all((r * Hl + i) // (H // KV) == g for g, hs in groups
                   for i in range(hs.start, hs.stop))


@pytest.mark.parametrize("H,KV,M", [(4, 2, 4), (6, 2, 3), (24, 8, 12), (16, 8, 16)])
def test_whole_cache_heads_equal_every_head(H, KV, M):
    """Each rank's query heads over a whole cache of KV kv heads
    (``layers._whole_cache_heads``: a call per kv head read, on a strided
    view of the cache), concatenated over the ranks: the decode of every
    head over the cache (the wrapper's plain version on the CPU), bit for
    bit, and no copy of the cache is made (its views share its storage)."""
    rng = np.random.default_rng(H * 100 + M)
    B, T, hd, p = 2, 13, 16, 9
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((B, T, KV, hd)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, T, KV, hd)).astype(np.float32))
    pos = torch.tensor(p, dtype=torch.int32)
    want = decode_ops.decode(q, kc.transpose(1, 2), vc.transpose(1, 2), pos)
    s = L.AttnSpec(d_model=32, n_heads=H, kv_heads=KV, head_dim=hd)
    Hl = H // M
    seen = []
    saved = decode_ops.decode

    def spy(q_, k_, v_, pos_, **kw):
        seen.append(k_.untyped_storage().data_ptr() == kc.untyped_storage().data_ptr())
        return saved(q_, k_, v_, pos_, **kw)

    decode_ops.decode = spy
    try:
        got = torch.cat([L._whole_cache_heads(q[:, r * Hl:(r + 1) * Hl], kc, vc, pos, s,
                                              TP(None, M, r)) for r in range(M)], dim=1)
    finally:
        decode_ops.decode = saved
    assert all(seen) and len(seen) >= M
    assert torch.equal(got, want)


@pytest.mark.parametrize("T,kv,M,want", [
    (4104, 8, 16, "whole"), (4096, 8, 16, "slots"), (4104, 16, 16, "heads"),
    (14, None, 3, "whole"), (24, None, 3, "slots"), (512, 1, 3, "whole")])
def test_cache_layout_of_every_leaf(T, kv, M, want):
    """``cache_layout``, the reference's spec of a cache leaf over a model
    axis of M: its slots where they divide, else its kv heads where they
    do (an MLA latent or rope key, no kv heads, stays whole), else whole."""
    assert cache_layout(T, kv, M) == want
