#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device  — GPU name, count, torch/CUDA versions, power limit;
  2. build   — compile the aggregation kernel from csrc/ with nvcc;
  3. kernel  — the CUDA kernel against its plain PyTorch version, bit for bit,
               at the main path's shape (K=20, R=51, S=44361) and ragged
               cases; kernel, plain-version and yardstick times (CUDA events)
               beside the bound;
  4. agree   — the vectorized engine against the scalar engine on the card
               (small config): traffic counters exact, weights within 1e-4;
  5. main    — the main path at full width: 100 agents train the paper's
               785x500x100x10 MLP on 60,000 samples for 3 rounds through
               make_simulation(engine="vectorized"); the kernel must launch
               once per round; the same run on the scalar engine is the
               reference (counters exact every round, weights within 1e-3
               after round 0).
Then the kernels line, the nvidia-smi line and, last, the result line.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# the main path: the paper's MNIST setting at 100 agents (phase 5)
MAIN_DATA = dict(num_train=60000, num_test=10000, seed=0)
MAIN_CFG = dict(
    num_agents=100, num_partitions=10, pi=2, rho=2, rounds=3, local_iters=10,
    batch_size=128, eval_agents=10, engine="vectorized",
)
MAIN_SHAPE = (20, 51, 44361)  # its kernel shape (K_inst, R_cap, S)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
WEIGHT_TOL = 1e-4  # engine agreement: f32 GEMM sums in other orders
# full width, round 0: each holder applies eps = 0.51 to a sum of r = 51
# deltas, which amplifies the per-delta GEMM-order noise up to 26-fold
ROUND0_TOL = 1e-3


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
    """Kernel vs plain version, bitwise, at the main shape and ragged ones."""
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
        _require(torch.equal(got, want), f"kernel != plain at {(K, R, S)}: max |d| {err}")
        _require(torch.equal(got[K // 2], w[K // 2]), f"zero mask row changed w at {(K, R, S)}")
    # the single-partition form (the reference's ipls_aggregate) is K=1
    w, d, mask, eps = _kernel_inputs(1, 5, 70001, seed=99, zero_row=False)
    got = ops.aggregate(w[0], d[0], mask[0], eps[0])
    want = ref.ipls_aggregate_batched_ref(w, d, mask, eps)[0]
    _require(torch.equal(got, want), "aggregate (K=1) != plain")

    K, R, S = MAIN_SHAPE
    w, d, mask, eps = _kernel_inputs(K, R, S, seed=0)
    ms = _time_ms(lambda: ops.aggregate_batched(w, d, mask, eps), iters=100, warmup=10)
    plain_ms = _time_ms(lambda: ref.ipls_aggregate_batched_ref(w, d, mask, eps), iters=5)
    # yardstick: one PyTorch call for the same function (never used by the
    # port; it rounds differently: cuBLAS reduces R in its own order)
    lib_ms = _time_ms(
        lambda: torch.baddbmm(w[:, None], (-eps[:, None] * mask)[:, None], d), iters=100,
        warmup=10,
    )
    single_ms = _time_ms(lambda: ops.aggregate(w[0], d[0], mask[0], eps[0]), iters=100)
    f32 = w.element_size()
    moved = (d.numel() + 2 * w.numel() + mask.numel() + eps.numel()) * f32
    flops = 2 * d.numel() + 2 * w.numel()
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    res = {
        "phase": "kernel", "shape": [K, R, S], "cases": len(cases) + 1,
        "max_abs_err": max_err, "tolerance": 0.0, "ms": ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "single_k1_ms": single_ms, "bytes_moved": moved,
        "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "achieved_gb_s": moved / (ms * 1e-3) / 1e9,
    }
    _emit(res)
    return res


def _weights_close(a, b):
    import numpy as np

    d = float(np.abs(a - b).max())
    return d, d <= WEIGHT_TOL


def phase_agree(mods):
    """Vectorized engine vs scalar engine on the card; vectorized CUDA vs CPU."""
    import numpy as np

    fl, data = mods["fl"], mods["data"]
    x_tr, y_tr, x_te, y_te = data.synth_mnist(num_train=1500, num_test=300, seed=0)
    cfg = fl.SimConfig(num_agents=5, num_partitions=8, pi=2, rho=2, rounds=3, local_iters=3)
    shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    sim_s = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    hist_s = sim_s.run()
    vcfg = dataclasses.replace(cfg, engine="vectorized")
    sim_v = fl.make_simulation(vcfg, shards, x_te, y_te, device="cuda")
    hist_v = sim_v.run()
    sim_c = fl.make_simulation(vcfg, shards, x_te, y_te, device="cpu")
    sim_c.run()
    for ms, mv in zip(hist_s, hist_v):
        _require(ms["bytes_total"] == mv["bytes_total"], f"bytes_total {ms} vs {mv}")
        _require(abs(ms["acc_mean"] - mv["acc_mean"]) <= 5e-3, f"acc {ms} vs {mv}")
    _require(sim_s.net.pubsub.messages_sent == sim_v.messages_sent, "messages_sent differ")
    w_s = np.stack([sim_s.agents[a].load_model() for a in range(cfg.num_agents)])
    w_v = sim_v.agent_weights()
    d_sv, ok_sv = _weights_close(w_s, w_v)
    d_cv, ok_cv = _weights_close(sim_c.agent_weights(), w_v)
    _require(ok_sv and ok_cv, f"weights differ: scalar {d_sv}, cpu {d_cv}")
    _emit({
        "phase": "agree", "rounds": cfg.rounds, "bytes_total": hist_v[-1]["bytes_total"],
        "messages_sent": sim_v.messages_sent, "max_w_diff_vs_scalar": d_sv,
        "max_w_diff_vs_cpu": d_cv, "tolerance": WEIGHT_TOL,
    })


def phase_main(mods, ops):
    """The main path at full width, through the user's entry points."""
    import numpy as np
    import torch

    fl, data, telemetry = mods["fl"], mods["data"], mods["telemetry"]
    t0 = time.perf_counter()
    x_tr, y_tr, x_te, y_te = data.synth_mnist(**MAIN_DATA)
    cfg = fl.SimConfig(**MAIN_CFG)
    shards = data.iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = fl.make_simulation(cfg, shards, x_te, y_te, device="cuda")
    setup_s = time.perf_counter() - t0
    shape = (sim.K_inst, sim.R_cap, sim.S)
    _require(shape == MAIN_SHAPE, f"main path kernel shape {shape} != {MAIN_SHAPE}")
    sim.timer = telemetry.PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.aggregate_batched.LAUNCHES = 0
    round_s, w_round0 = [], None
    for rnd in range(cfg.rounds):
        t0 = time.perf_counter()
        sim.run_round(rnd)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        if rnd == 0:
            w_round0 = sim.agent_weights()
    launches = ops.aggregate_batched.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    _require(launches == cfg.rounds, f"kernel launched {launches} times in {cfg.rounds} rounds")
    accs = [h["acc_mean"] for h in sim.history]
    _require(all(math.isfinite(a) for a in accs), f"non-finite accuracy {accs}")
    w_v = sim.agent_weights()
    _require(bool(np.isfinite(w_v).all()), "non-finite weights")

    # reference: the scalar engine (numpy aggregation) on the same inputs.
    # Traffic must match every round. Weights are held to ROUND0_TOL after
    # round 0: at 100 agents the eps recursion starts at 1.0 while r = 51,
    # so later rounds overshoot and amplify float noise chaotically (the
    # reference package does the same); the final gap is reported.
    t0 = time.perf_counter()
    ref = fl.make_simulation(dataclasses.replace(cfg, engine="scalar"), shards, x_te, y_te)
    d_round0 = None
    for rnd in range(cfg.rounds):
        ref.run_round(rnd)
        if rnd == 0:
            w_r = np.stack([ref.agents[a].load_model() for a in range(cfg.num_agents)])
            d_round0 = float(np.abs(w_r - w_round0).max())
            _require(d_round0 <= ROUND0_TOL, f"round-0 weights differ by {d_round0}")
    scalar_s = time.perf_counter() - t0
    for mr, mv in zip(ref.history, sim.history):
        _require(mr["bytes_total"] == mv["bytes_total"], f"bytes_total {mr} vs {mv}")
    _require(ref.net.pubsub.messages_sent == sim.messages_sent, "messages_sent differ")
    w_r = np.stack([ref.agents[a].load_model() for a in range(cfg.num_agents)])
    res = {
        "phase": "main", "agents": cfg.num_agents, "params": sim.N, "rounds": cfg.rounds,
        "kernel_shape": list(shape), "launches": launches, "round_s": round_s,
        "phases_s": {k: v["total_s"] for k, v in sim.timer.summary().items()},
        "acc_mean": accs, "acc_mean_scalar": [h["acc_mean"] for h in ref.history],
        "bytes_total": sim.history[-1]["bytes_total"], "messages_sent": sim.messages_sent,
        "max_memory_allocated": peak, "data_s": data_s, "setup_s": setup_s,
        "scalar_engine_s": scalar_s, "max_w_diff_vs_scalar_round0": d_round0,
        "tolerance": ROUND0_TOL, "max_abs_w_round0": float(np.abs(w_round0).max()),
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

    mods = {"data": data, "fl": fl, "telemetry": telemetry}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    meta = telemetry.host_metadata()
    _emit({"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi, **meta})

    t0 = time.perf_counter()
    ops.build()
    _emit({"phase": "build", "seconds": time.perf_counter() - t0})

    kern = phase_kernel(ops, ref)
    phase_agree(mods)
    main_res = phase_main(mods, ops)

    _emit({"kernels": [{
        "name": "ipls_aggregate_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/ipls_aggregate/csrc/ipls_aggregate.cu",
        "replaces": "src/repro/kernels/ipls_aggregate/ipls_aggregate.py:150",
        "launches": main_res["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
    }]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
