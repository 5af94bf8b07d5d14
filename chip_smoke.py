#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in this order, each printing one JSON line; any failure raises and
exits non-zero:
  device    — GPU name, count, torch/CUDA versions, power limit;
  build     — compile every kernel library from csrc/ with nvcc, all at once;
  agree     — the batched engine against the scalar engine on the card at a
              small config (PERFECT f32 and int8, LOSSY f32 and int8, long
              delays int8), and the card against the CPU: traffic counters
              exact; weights within 1e-4 on the f32 wire; on the int8 wire
              within a bound for codes flipped by SGD float noise, and
              within 1e-4 once that noise is removed (float64 SGD);
  main      — the PERFECT f32 path at full width: 100 agents train the
              paper's 785x500x100x10 MLP on 60,000 samples for 3 rounds
              through make_simulation(engine="vectorized"); the scalar engine
              is the reference (counters exact, round-0 weights within 1e-3);
  main_int8 — the same at full width on the LOSSY network and the int8 wire;
  kernel    — the f32 aggregation kernel against its plain PyTorch version,
              bit for bit, at the main path's shape (K=20, R=51, S=44361),
              ragged cases and the single-partition form; kernel (device
              time from CUDA-graph replay, and per wrapper call), plain and
              one-call yardstick times (CUDA events) beside the bound;
  kernel_q  — the int8 codec kernels (quantize, dequantize) and the quantized
              aggregation kernel against their plain versions, bit for bit,
              at the int8 path's shapes and edge cases; times and bounds.
Each main phase sets every kernel's launch count to 0 before it runs and
requires the counts its path must give. Then the kernels line, the
nvidia-smi line and, last, the result line. Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np

# the main path: the paper's MNIST setting at 100 agents
MAIN_DATA = dict(num_train=60000, num_test=10000, seed=0)
MAIN_CFG = dict(
    num_agents=100, num_partitions=10, pi=2, rho=2, rounds=3, local_iters=10,
    batch_size=128, eval_agents=10, engine="vectorized",
)
MAIN_SHAPE = (20, 51, 44361)  # its kernel shape (K_inst, R_cap, S)
# the int8 path at full width (LOSSY: delays of at most 2 ticks, one round
# late, so R_cap = (A-1)*2 remote rows; S padded to whole 1024-blocks)
MAIN_Q_SHAPE = (20, 198, 45056)
DELTA_PLANE = 100 * 10 * 45056  # values the int8 path quantizes per round
VALUE_PLANE = 20 * 45056  # values of one qdq_rows call (the instance plane)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
WEIGHT_TOL = 1e-4  # engine agreement: f32 GEMM sums in other orders
# full width, round 0: each holder applies eps = 0.51 to a sum of r = 51
# deltas, which amplifies the per-delta GEMM-order noise up to 26-fold
ROUND0_TOL = 1e-3
AGREE_CFG = dict(num_agents=5, num_partitions=8, pi=2, rho=2, rounds=3, local_iters=3)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, launches: int = 20, replays: int = 10) -> dict:
    """A call's time two ways: ``call_ms``, CUDA events around 50
    back-to-back calls (for a kernel, the wrapper's Python checks and ctypes
    call included, as the engine pays them), and ``ms``, the device's own
    time per call: ``launches`` calls captured into one CUDA graph and
    replayed, so no host work is on the clock. Inputs of a few MB stay in
    the 50 MB L2 cache across replays."""
    import torch

    call_ms = _time_ms(fn, iters=50, warmup=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = _time_ms(graph.replay, iters=replays, warmup=1) / launches
    return {"ms": ms, "call_ms": call_ms}


def _bound(moved_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {
        "bytes_moved": moved_bytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def _bits_equal(a, b) -> bool:
    """Bitwise equality (a -0 differs from a +0)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _kernel_inputs(K, R, S, seed, zero_row=True):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, S), generator=g, device="cuda")
    d = torch.randn((K, R, S), generator=g, device="cuda")
    mask = torch.randint(0, 2, (K, R), generator=g, device="cuda").float()
    if zero_row:
        mask[K // 2] = 0.0  # a zero-contributor instance passes w through
    eps = torch.rand((K,), generator=g, device="cuda") * 0.9 + 0.1
    return w, d, mask, eps


def phase_kernel(ops, ref):
    """f32 aggregation kernel vs plain version, bitwise, at the main shape
    and ragged ones; the single-partition form (kernel table row 2)."""
    import torch

    cases = [MAIN_SHAPE, (3, 1, 70001), (3, 5, 70001), (1, 5, 4097), (7, 11, 1)]
    max_err = 0.0
    for i, (K, R, S) in enumerate(cases):
        w, d, mask, eps = _kernel_inputs(K, R, S, seed=i)
        got = ops.aggregate_batched(w, d, mask, eps)
        want = ref.ipls_aggregate_batched_ref(w, d, mask, eps)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        _require(_bits_equal(got, want), f"kernel != plain at {(K, R, S)}: max |d| {err}")
        _require(torch.equal(got[K // 2], w[K // 2]), f"zero mask row changed w at {(K, R, S)}")
    # the single-partition form (the reference's ipls_aggregate) is K=1
    w, d, mask, eps = _kernel_inputs(1, 5, 70001, seed=99, zero_row=False)
    got = ops.aggregate(w[0], d[0], mask[0], eps[0])
    want = ref.ipls_aggregate_batched_ref(w, d, mask, eps)[0]
    _require(_bits_equal(got, want), "aggregate (K=1) != plain")

    K, R, S = MAIN_SHAPE
    w, d, mask, eps = _kernel_inputs(K, R, S, seed=0)
    times = _device_ms(lambda: ops.aggregate_batched(w, d, mask, eps))
    plain_ms = _time_ms(lambda: ref.ipls_aggregate_batched_ref(w, d, mask, eps), iters=5)
    # yardstick: one PyTorch call for the same function (never used by the
    # port; it rounds differently: cuBLAS reduces R in its own order)
    coef = (-eps[:, None] * mask)[:, None]
    lib = _device_ms(lambda: torch.baddbmm(w[:, None], coef, d))
    f32 = w.element_size()
    res = {
        "phase": "kernel", "shape": [K, R, S], "cases": len(cases) + 1,
        "max_abs_err": max_err, "tolerance": 0.0, **times, "plain_ms": plain_ms,
        "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
        **_bound((d.numel() + 2 * w.numel() + mask.numel() + eps.numel()) * f32,
                 2 * d.numel() + 2 * w.numel()),
    }
    res["achieved_gb_s"] = res["bytes_moved"] / (res["ms"] * 1e-3) / 1e9
    # kernel table row 2: the single-partition form at (1, 51, 44361)
    w1, d1, m1, e1 = w[0], d[0], mask[0], eps[0]
    coef1 = -e1 * m1
    lib1 = _device_ms(lambda: torch.addmv(w1, d1.t(), coef1))  # w + d^T (-eps*mask)
    res["single"] = {
        "shape": [1, R, S],
        **_device_ms(lambda: ops.aggregate(w1, d1, m1, e1)),
        "plain_ms": _time_ms(
            lambda: ref.ipls_aggregate_batched_ref(w[:1], d[:1], mask[:1], eps[:1]), iters=5
        ),
        "library_ms": lib1["ms"], "library_call_ms": lib1["call_ms"],
        **_bound((d1.numel() + 2 * w1.numel() + m1.numel() + 1) * f32,
                 2 * d1.numel() + 2 * w1.numel()),
    }
    _emit(res)
    return res


def _codec_input(n: int, seed: int):
    """x and err of n values whose 1024-blocks cycle through the codec's
    edge cases: ordinary values, all-zero blocks, blocks below 2**-120
    (subnormals included), codes that clip at +-127, exact .5 ties."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * 0.01
    err = torch.randn(n, generator=g, device="cuda") * 1e-4
    nb = -(-n // 1024)
    pad = nb * 1024 - n
    xb = torch.nn.functional.pad(x, (0, pad)).view(nb, 1024)
    eb = torch.nn.functional.pad(err, (0, pad)).view(nb, 1024)
    kind = torch.arange(nb, device="cuda") % 5
    tiny = torch.randn((nb, 1024), generator=g, device="cuda") * 2.0**-135
    clip = (torch.rand((nb, 1024), generator=g, device="cuda") * 2 - 1) * 1.999
    clip[:, 0], clip[:, 1] = 1.999, -1.999
    ties = (torch.randint(-120, 120, (nb, 1024), generator=g, device="cuda") + 0.5) / 64
    ties[:, 0] = 1.5  # block absmax in [1, 2): scale 2**-6, (k + 0.5) / 64 are ties
    for k, vals in ((1, torch.zeros_like(tiny)), (2, tiny), (3, clip), (4, ties)):
        sel = kind == k
        xb[sel] = vals[sel]
        eb[sel] = 0.0
    flat = xb.reshape(-1)[:n].contiguous(), eb.reshape(-1)[:n].contiguous()
    return flat


def _agg_q_inputs(K, R, S, seed):
    """Codes over the full [-127, 127], power-of-two and zero scales, a
    zero-mask instance and an instance with own_mask = 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = -(-S // 1024)
    w = torch.randn((K, S), generator=g, device="cuda")
    own = torch.randn((K, S), generator=g, device="cuda")
    q = torch.randint(-127, 128, (K, R, S), generator=g, device="cuda").to(torch.int8)
    q.view(-1)[:2] = torch.tensor([-127, 127], dtype=torch.int8, device="cuda")[: q.numel()]
    scales = torch.exp2(torch.randint(-20, 2, (K, R, nb), generator=g, device="cuda").float())
    scales[torch.rand((K, R, nb), generator=g, device="cuda") < 0.2] = 0.0
    mask = torch.randint(0, 2, (K, R), generator=g, device="cuda").float()
    mask[K // 2] = 0.0
    own_mask = torch.ones(K, device="cuda")
    own_mask[0] = 0.0
    eps = torch.rand((K,), generator=g, device="cuda") * 0.9 + 0.1
    return w, own, q, scales, mask, own_mask, eps


def phase_kernel_q(qops, qref, ops, ref):
    """int8 codec and quantized aggregation kernels vs plain versions,
    bitwise; times at the int8 path's shapes."""
    import torch

    max_err = {"quantize": 0.0, "dequantize": 0.0, "ipls_aggregate_batched_q": 0.0}
    for i, n in enumerate([DELTA_PLANE, VALUE_PLANE, 1, 1025, 8193, 70001]):
        x, err = _codec_input(n, seed=100 + i)
        q, s, ne = qops.quantize(x, err)
        q_r, s_r, ne_r = qref.quantize(x, err)
        deq = qops.dequantize(q_r, s_r)
        deq_r = qref.dequantize(q_r, s_r)
        torch.cuda.synchronize()
        d_q = max((q.int() - q_r.int()).abs().max().item(), (s - s_r).abs().max().item(),
                  (ne - ne_r).abs().max().item())
        max_err["quantize"] = max(max_err["quantize"], d_q)
        max_err["dequantize"] = max(max_err["dequantize"], (deq - deq_r).abs().max().item())
        _require(_bits_equal(q, q_r) and _bits_equal(s, s_r) and _bits_equal(ne, ne_r),
                 f"quantize != plain at N={n}: max |d| {d_q}")
        _require(_bits_equal(deq, deq_r), f"dequantize != plain at N={n}")
        if n >= 8193:  # the edge cases really occur
            _require(bool((s == 0).any()) and int(q.abs().max()) == 127, f"edge cases at N={n}")
    for i, shape in enumerate([MAIN_Q_SHAPE, (20, 99, 45056), (3, 5, 70001), (7, 11, 1)]):
        args = _agg_q_inputs(*shape, seed=200 + i)
        got = ops.aggregate_batched_q(*args)
        want = ref.ipls_aggregate_batched_q_ref(*args)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        max_err["ipls_aggregate_batched_q"] = max(max_err["ipls_aggregate_batched_q"], e)
        _require(_bits_equal(got, want), f"aggregate_batched_q != plain at {shape}: {e}")

    res = {"phase": "kernel_q", "max_abs_err": max_err, "tolerance": 0.0, "timings": {}}
    no_lib = "no single PyTorch call computes it"
    for n in (DELTA_PLANE, VALUE_PLANE):
        x, err = _codec_input(n, seed=7)
        q, s, _ = qref.quantize(x, err)
        nb = s.numel()
        res["timings"][f"quantize@{n}"] = {
            **_device_ms(lambda: qops.quantize(x, err)),
            "plain_ms": _time_ms(lambda: qref.quantize(x, err), iters=5),
            # block absmax with power-of-two scales and error feedback
            "library_ms": None, "library": no_lib,
            **_bound(n * (4 + 4 + 1 + 4) + nb * 4, 10 * n),
        }
        q2, s2 = q.view(nb, 1024), s[:, None]
        # yardstick: one broadcast multiply (int8 x float32 promotes)
        lib = _device_ms(lambda: torch.mul(q2, s2))
        res["timings"][f"dequantize@{n}"] = {
            **_device_ms(lambda: qops.dequantize(q, s)),
            "plain_ms": _time_ms(lambda: qref.dequantize(q, s), iters=5),
            "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
            **_bound(n * (1 + 4) + nb * 4, n),
        }
    for shape in (MAIN_Q_SHAPE, (20, 99, 45056)):
        K, R, S = shape
        args = _agg_q_inputs(K, R, S, seed=9)
        res["timings"][f"aggregate_batched_q@{K}x{R}x{S}"] = {
            **_device_ms(lambda: ops.aggregate_batched_q(*args)),
            "plain_ms": _time_ms(lambda: ref.ipls_aggregate_batched_q_ref(*args), iters=3),
            # dequantize fused into an ordered masked sum over int8 codes
            "library_ms": None, "library": no_lib,
            **_bound(K * R * S + K * R * (-(-S // 1024)) * 4 + 3 * K * S * 4 + K * R * 4 + 2 * K * 4,
                     3 * K * R * S + 2 * K * S),
        }
    _emit(res)
    return res


@contextmanager
def _float64_sgd(mlp_mnist):
    """Local SGD in float64, rounded to float32 once per round. Per-agent
    (scalar engine) and batched (batched engine) float32 products differ in
    their last bits, and on the int8 wire that noise flips a code now and
    then (one scale step, 2**-10 for weights near 0.1). Without it the two
    engines agree bit for bit on the CPU (tests/test_torch_int8.py), so the
    protocol and the kernels can be held to 1e-4 on the card too."""
    sgd = mlp_mnist.sgd_steps_flat_batched
    mlp_mnist.sgd_steps_flat_batched = (
        lambda W, X, Y, lr, iters, layout: sgd(W.double(), X.double(), Y, lr, iters, layout).float()
    )
    try:
        yield
    finally:
        mlp_mnist.sgd_steps_flat_batched = sgd


def _flip_bound(w_a, w_b, offsets, sizes, base):
    """Per-weight bound between two int8-wire runs whose local SGD differs by
    float noise. Every weight an agent reads is a wire image (code * scale of
    its partition's 1024-block) or a merge of a raw value with such images.
    The noise can move a value across a rounding boundary of the codec: one
    flipped code moves the image by one scale step of its block, or by at
    most two steps of the larger scale where the block's absmax crosses a
    power of two between the runs. A flipped delta code moves an aggregate
    by eps times one step of the delta's block, smaller still (deltas are a
    few percent of the values). So each weight is held to two scale steps of
    its block, 2 * 2**(E - 6) for the block absmax 2**E * m (the larger of
    the two runs'), plus ``base`` for the float32 noise itself."""
    bound = np.empty_like(w_a)
    amax = np.maximum(np.abs(w_a), np.abs(w_b))
    for off, s in zip(offsets, sizes):
        nb = -(-int(s) // 1024)
        blk = np.zeros((amax.shape[0], nb * 1024), np.float32)
        blk[:, :s] = amax[:, off : off + s]
        bmax = blk.reshape(amax.shape[0], nb, 1024).max(axis=2)
        step = np.exp2(np.floor(np.log2(np.maximum(bmax, 2.0**-120))) - 6)
        bound[:, off : off + s] = np.repeat(2 * step, 1024, axis=1)[:, :s] + base
    return bound


def _weights_check(w_ref, w, sim, base):
    """Max |difference|, how many weights differ by more than 1e-4, and
    whether the run passes: within ``base`` on the f32 wire; on the int8
    wire within the flip bound, with flips rare (at most 1e-3 of the
    weights beyond 1e-4)."""
    diff = np.abs(w_ref - w)
    n_over = int((diff > WEIGHT_TOL).sum())
    if sim.cfg.wire_dtype == "int8":
        ok = bool((diff <= _flip_bound(w_ref, w, sim._offsets, sim._sizes, base)).all())
        ok = ok and n_over <= 1e-3 * diff.size
    else:
        ok = float(diff.max()) <= base
    return {"max": float(diff.max()), "n_over_1e-4": n_over, "n": int(diff.size)}, ok


def _agree_runs(fl, cfg, shards, x_te, y_te):
    sim_s = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    sim_s.run()
    vcfg = dataclasses.replace(cfg, engine="vectorized")
    sim_v = fl.make_simulation(vcfg, shards, x_te, y_te, device="cuda")
    sim_v.run()
    sim_c = fl.make_simulation(vcfg, shards, x_te, y_te, device="cpu")
    sim_c.run()
    w_s = np.stack([sim_s.agents[a].load_model() for a in range(cfg.num_agents)])
    return sim_s, sim_v, w_s, sim_v.agent_weights(), sim_c.agent_weights()


def phase_agree(mods):
    """Batched engine vs scalar engine on the card, and card vs CPU, on each
    network / wire combination of the two paths. Counters exact; weights
    within 1e-4 (f32 wire), within the flip bound (int8 wire), and within
    1e-4 on the int8 wire once the SGD noise is removed (float64 SGD)."""
    fl, data, net = mods["fl"], mods["data"], mods["network"]
    x_tr, y_tr, x_te, y_te = data.synth_mnist(num_train=1500, num_test=300, seed=0)
    cases = {
        "perfect_f32": {},
        "perfect_int8": dict(wire_dtype="int8"),
        "lossy_f32": dict(conditions=net.LOSSY),
        "lossy_int8": dict(conditions=net.LOSSY, wire_dtype="int8"),
        "deep_int8": dict(
            conditions=net.NetworkConditions(loss_prob=0.2, delay_prob=0.5, max_delay_rounds=6),
            wire_dtype="int8",
        ),
    }
    out = {}
    for name, extra in cases.items():
        cfg = fl.SimConfig(**AGREE_CFG, **extra)
        shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
        sim_s, sim_v, w_s, w_v, w_c = _agree_runs(fl, cfg, shards, x_te, y_te)
        for ms, mv in zip(sim_s.history, sim_v.history, strict=True):
            _require(ms["bytes_total"] == mv["bytes_total"], f"{name}: bytes_total {ms} vs {mv}")
            _require(abs(ms["acc_mean"] - mv["acc_mean"]) <= 5e-3, f"{name}: acc {ms} vs {mv}")
        ps = sim_s.net.pubsub
        _require(ps.messages_sent == sim_v.messages_sent, f"{name}: messages_sent differ")
        _require(ps.messages_dropped == sim_v.messages_dropped, f"{name}: messages_dropped differ")
        if cfg.conditions.loss_prob > 0:
            _require(sim_v.messages_dropped > 0, f"{name}: no message was dropped")
        vs_scalar, ok_s = _weights_check(w_s, w_v, sim_v, WEIGHT_TOL)
        vs_cpu, ok_c = _weights_check(w_c, w_v, sim_v, WEIGHT_TOL)
        _require(ok_s and ok_c, f"{name}: weights differ: scalar {vs_scalar}, cpu {vs_cpu}")
        res = {
            "bytes_total": sim_v.history[-1]["bytes_total"], "messages_sent": sim_v.messages_sent,
            "messages_dropped": sim_v.messages_dropped, "R_cap": sim_v.R_cap,
            "w_diff_vs_scalar": vs_scalar, "w_diff_vs_cpu": vs_cpu,
        }
        if cfg.wire_dtype == "int8":
            with _float64_sgd(mods["mlp_mnist"]):
                _, sim_v, w_s, w_v, w_c = _agree_runs(fl, cfg, shards, x_te, y_te)
            d_s, d_c = float(np.abs(w_s - w_v).max()), float(np.abs(w_c - w_v).max())
            _require(max(d_s, d_c) <= WEIGHT_TOL,
                     f"{name}, float64 SGD: weights differ: scalar {d_s}, cpu {d_c}")
            res["float64_sgd"] = {"max_w_diff_vs_scalar": d_s, "max_w_diff_vs_cpu": d_c}
        out[name] = res
    _emit({"phase": "agree", "rounds": AGREE_CFG["rounds"], "tolerance": WEIGHT_TOL,
           "cases": out})


def _reset_launches(kmods):
    for fn in kmods.values():
        fn.LAUNCHES = 0


def phase_main(mods, kmods, name, extra, shape, want):
    """A full-width path through the user's entry points: counts reset, the
    path run, every count read; the scalar engine on the same inputs is the
    reference (counters exact every round, round-0 weights bounded)."""
    import torch

    fl, data, telemetry = mods["fl"], mods["data"], mods["telemetry"]
    t0 = time.perf_counter()
    x_tr, y_tr, x_te, y_te = data.synth_mnist(**MAIN_DATA)
    cfg = fl.SimConfig(**MAIN_CFG, **extra)
    shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    setup_s = time.perf_counter() - t0
    got_shape = (sim.K_inst, sim.R_cap, sim.S)
    _require(got_shape == shape, f"{name}: kernel shape {got_shape} != {shape}")
    sim.timer = telemetry.PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kmods)
    round_s, w_round0 = [], None
    for rnd in range(cfg.rounds):
        t0 = time.perf_counter()
        sim.run_round(rnd)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        if rnd == 0:
            w_round0 = sim.agent_weights()
    launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
    peak = torch.cuda.max_memory_allocated()
    _require(launches == want, f"{name}: launches {launches}, expected {want}")
    accs = [h["acc_mean"] for h in sim.history]
    _require(all(math.isfinite(a) for a in accs), f"{name}: non-finite accuracy {accs}")
    w_v = sim.agent_weights()
    _require(bool(np.isfinite(w_v).all()), f"{name}: non-finite weights")

    # reference: the scalar engine (numpy protocol) on the same inputs.
    # Traffic must match every round. Weights are held to a bound after
    # round 0 only: at 100 agents the eps recursion starts at 1.0 while
    # r = 51, so later rounds overshoot and amplify float noise chaotically
    # (the reference package does the same); the final gap is reported.
    t0 = time.perf_counter()
    ref = fl.make_simulation(
        dataclasses.replace(cfg, engine="scalar"), shards, x_te, y_te, device="cuda"
    )
    r0 = {}
    for rnd in range(cfg.rounds):
        mr = ref.run_round(rnd)
        mv = sim.history[rnd]
        _require(mr["bytes_total"] == mv["bytes_total"], f"{name}: bytes_total {mr} vs {mv}")
        if rnd == 0:
            w_r = np.stack([ref.agents[a].load_model() for a in range(cfg.num_agents)])
            diff = np.abs(w_r - w_round0)
            if cfg.wire_dtype == "int8":
                # flipped codes (see _flip_bound), on top of the f32 bound
                tol = _flip_bound(w_r, w_round0, sim._offsets, sim._sizes, ROUND0_TOL)
                r0["tolerance"] = "2 code steps of the weight's block + 1e-3, per weight"
                r0["max_tolerance"] = float(tol.max())
            else:
                tol = ROUND0_TOL
                r0["tolerance"] = ROUND0_TOL
            r0.update(max_w_diff_vs_scalar_round0=float(diff.max()),
                      n_over_1e_4=int((diff > WEIGHT_TOL).sum()), n_weights=int(diff.size))
            _require(bool((diff <= tol).all()), f"{name}: round-0 weights differ by {diff.max()}")
    ps = ref.net.pubsub
    _require(ps.messages_sent == sim.messages_sent, f"{name}: messages_sent differ")
    _require(ps.messages_dropped == sim.messages_dropped, f"{name}: messages_dropped differ")
    scalar_s = time.perf_counter() - t0
    w_r = np.stack([ref.agents[a].load_model() for a in range(cfg.num_agents)])
    res = {
        "phase": name, "agents": cfg.num_agents, "params": sim.N, "rounds": cfg.rounds,
        "conditions": dataclasses.asdict(cfg.conditions), "wire_dtype": cfg.wire_dtype,
        "kernel_shape": list(got_shape), "launches": launches, "round_s": round_s,
        "phases_s": {k: v["total_s"] for k, v in sim.timer.summary().items()},
        "acc_mean": accs, "acc_mean_scalar": [h["acc_mean"] for h in ref.history],
        "bytes_total": sim.history[-1]["bytes_total"], "messages_sent": sim.messages_sent,
        "messages_dropped": sim.messages_dropped, "max_memory_allocated": peak,
        "data_s": data_s, "setup_s": setup_s, "scalar_engine_s": scalar_s, **r0,
        "max_abs_w_round0": float(np.abs(w_round0).max()),
        "max_abs_w_final": float(np.abs(w_v).max()),
        "max_w_diff_vs_scalar_final": float(np.abs(w_r - w_v).max()),
    }
    _emit(res)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import data, fl, telemetry
    from repro_torch.kernels.ipls_aggregate import ops, ref
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.models import mlp_mnist
    from repro_torch.p2p import network

    mods = {"data": data, "fl": fl, "telemetry": telemetry, "network": network,
            "mlp_mnist": mlp_mnist}
    kmods = {
        "ipls_aggregate_batched": ops.aggregate_batched,
        "ipls_aggregate_batched_q": ops.aggregate_batched_q,
        "quantize": qops.quantize,
        "dequantize": qops.dequantize,
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    meta = telemetry.host_metadata()
    _emit({"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi, **meta})

    def timed_build(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source, at once
        futs = {"ipls_aggregate": pool.submit(timed_build, ops),
                "quantize": pool.submit(timed_build, qops)}
        build_s = {k: f.result() for k, f in futs.items()}
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_library_s": build_s})

    # the engine phases first: the timing phases below leave cuBLAS
    # workspaces of their graph captures allocated, which would count in
    # the main paths' peak memory
    phase_agree(mods)
    none = dict.fromkeys(kmods, 0)
    rounds = MAIN_CFG["rounds"]
    main_f32 = phase_main(mods, kmods, "main", {}, MAIN_SHAPE,
                          dict(none, ipls_aggregate_batched=rounds))
    # per round: quantize the delta plane once and qdq_rows twice (V before
    # the round, V_agg after aggregation), one quantized aggregation
    main_q = phase_main(
        mods, kmods, "main_int8", dict(wire_dtype="int8", conditions=network.LOSSY),
        MAIN_Q_SHAPE,
        dict(none, ipls_aggregate_batched_q=rounds, quantize=3 * rounds, dequantize=2 * rounds),
    )
    kern = phase_kernel(ops, ref)
    kern_q = phase_kernel_q(qops, qref, ops, ref)

    t = kern_q["timings"]
    agg_q = t["aggregate_batched_q@{}x{}x{}".format(*MAIN_Q_SHAPE)]
    rows = [
        ("ipls_aggregate_batched", "ipls_aggregate/csrc/ipls_aggregate.cu",
         "kernels/ipls_aggregate/ipls_aggregate.py:150", main_f32, kern["max_abs_err"], kern),
        ("ipls_aggregate_batched_q", "ipls_aggregate/csrc/ipls_aggregate.cu",
         "kernels/ipls_aggregate/ipls_aggregate.py:245", main_q,
         kern_q["max_abs_err"]["ipls_aggregate_batched_q"], agg_q),
        ("quantize", "quantize/csrc/quantize.cu", "kernels/quantize/quantize.py:62", main_q,
         kern_q["max_abs_err"]["quantize"], t[f"quantize@{DELTA_PLANE}"]),
        ("dequantize", "quantize/csrc/quantize.cu", "kernels/quantize/quantize.py:107", main_q,
         kern_q["max_abs_err"]["dequantize"], t[f"dequantize@{VALUE_PLANE}"]),
    ]
    _emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
        "replaces": f"src/repro/{replaces}", "path": path["phase"],
        "launches": path["launches"][name], "max_abs_err": err, "ms": tm["ms"],
        "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"],
    } for name, source, replaces, path, err, tm in rows]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
