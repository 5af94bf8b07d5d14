#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in this order, each printing one JSON line; any failure raises and
exits non-zero:
  device    — GPU name, count, torch/CUDA versions, power limit;
  build     — compile every kernel library from csrc/ with nvcc, all at once;
              then the flash and decode libraries' kernels: registers, spills
              and static shared memory (ptxas), dynamic shared memory, and
              the count of HGMMA (wgmma) instructions in the flash library's
              SASS, which must be > 0;
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
  lm_agree  — the LMs (internlm2, phi4-mini, minitron, rwkv6) at their reduced
              configs: the port on the card (attention and scan kernels)
              against the port on the CPU (plain versions), same weights from
              one seed, prompts of 16 and 100 tokens, 8 decode steps; logits
              within one bfloat16 ulp (+1e-5) in float32 weights, within
              0.03 in bf16;
  serve     — the LM main path at full width: internlm2-1.8b
              (1,889,110,016 parameters, bf16) through build_model and
              serve_lm.generate, batch 4, a 4,096-token prompt from the seed,
              256 greedy tokens; exactly 24 flash-attention and 24 x 255
              flash-decode launches; prefill and decode times, peak memory,
              flash attention's share of the prefill's device time,
              finite logits; decode at pos 4,096 against the last-token
              logits of a 4,097-token prefill, in bf16 and, for the served
              prompt and a second one, in float32 weights;
  serve_rwkv — the RWKV6 path at full width: rwkv6-7b (7,534,546,944
              parameters, bf16) through build_model and serve_lm.generate,
              batch 4, a 4,096-token prompt from the seed, 128 greedy tokens;
              exactly 32 linear-scan launches (one per time-mix layer, in the
              prefill) and none of any other kernel; the same numbers and
              checks as serve, the 4,097-token prefill running the kernel's
              ragged last chunk;
  kernel    — the f32 aggregation kernel against its plain PyTorch version,
              bit for bit, at the main path's shape (K=20, R=51, S=44361),
              ragged cases and the single-partition form; kernel (device
              time from CUDA-graph replay, and per wrapper call), plain and
              one-call yardstick times (CUDA events) beside the bound;
  kernel_q  — the int8 codec kernels (quantize, dequantize) and the quantized
              aggregation kernel against their plain versions, bit for bit,
              at the int8 path's shapes and edge cases; times and bounds;
  kernel_attn — the attention kernels against their plain versions at the
              serve shapes (flash B=4, H=16, KV=8, S=4096, D=128; decode at
              T=4352, pos 0, 255, 4095, 4351) and ragged ones (flash S = 1,
              100, 128, 129, 300, 4097, and q x 8 to drive the online
              rescale): float32 within 2e-5; decode in bf16 within one bf16
              ulp (+2e-5), two calls bitwise equal, and a CUDA graph of one
              decode call replayed with pos 0, 255, 4095, 4351 written into
              its pos tensor bitwise equal to the eager call and within the
              same bound of the plain version; flash in bf16, which rounds
              P to bf16 on the tensor cores, within 2**-7 * attn(q, k, |v|)
              + one bf16 ulp + 2e-5 of both the plain version and the plain
              tiled version (with, for each, the elements beyond two bf16
              ulps); times beside the bound (achieved TFLOP/s, share of the
              bound; decode: the split count and the other candidate's time)
              and scaled_dot_product_attention as the yardstick;
  kernel_scan — the linear-scan kernel against both plain versions (step
              oracle, chunked scan) at the serve shape (4, 4096, 64, 64) in
              float32 and bf16, T = 1, 100 and 4,097, one head, an initial
              state, a nonzero bonus, strided inputs and log-decays over the
              model's whole clip range: within 3e-5 of the output's scale
              (bf16: one bf16 ulp more); times beside the bound (no PyTorch
              call computes the recurrence).
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
# the LM main path: internlm2-1.8b at full width, serving
SERVE = dict(arch="internlm2-1.8b", batch=4, prompt_len=4096, tokens=256, seed=0)
SERVE_PARAMS = 1_889_110_016
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
LM_AGREE_CASES = ((16, 32), (100, 128))  # (prompt length, cache_len)
LM_AGREE_STEPS = 8
# bf16 logits, card vs CPU: both sides run the port's own code, so only the
# order of float32 sums and the roundings to bf16 differ (measured at most
# 8.3e-3 on an H100, about one bf16 ulp at logits of 1-2)
LM_BF16_TOL = 0.03
# decode at pos 4,096 vs the last-token logits of a 4,097-token prefill
# (logits of std about 1.8). The two paths round differently: GEMMs of M = 4
# against M = 16,388 rows, two attention kernels summing in other orders.
# The reference's init (std 1/sqrt(24) on every weight) gives each layer a
# large gain, so 24 layers amplify those differences: in a float32 copy of
# the weights the two paths differed by 0.03125 on an H100 (2 bf16 ulps at
# |logit| 2-4; the same on a second prompt, so the bound is 3.2x the larger
# reading), and in bf16 each side's own roundings add more (0.297). A
# wrong cache slot, position or mask moves logits by their whole scale.
SERVE_DECODE_VS_PREFILL_BF16 = 0.5
SERVE_DECODE_VS_PREFILL_F32 = 0.1
# the attention kernels against their plain versions
ATTN_F32_TOL = 2e-5  # as tests/test_kernels.py
# The bf16 flash kernel rounds P = exp(s - m) to bf16 before P V (tensor cores),
# each p within a relative 2**-8, so each output within 2**-8 * attn(q, k, |v|)
# of the float32 product: it is held to twice that, plus one bf16 ulp of the
# larger magnitude (the final roundings) and ATTN_F32_TOL (outputs near 0).
# Decode and the float32 flash path keep one bf16 ulp (+2e-5) and 2e-5.
# The plain tiled version rounds P too, but from float32 p that differ from
# the kernel's in their last bits (summation order, ex2.approx, the folded
# scale): where a bf16 rounding midpoint lies between the two, they round one
# bf16 ulp of p apart. Each is within 2**-8 * attn(q, k, |v|) of the float32
# product, so the two are within 2**-7 * attn(q, k, |v|): the same bound.
FLASH_BF16_P_ROUNDING = 2.0**-7
FLASH_SHAPE = (4, 16, 8, 4096, 128)  # B, H, KV, S, D of the serve prefill
# (shape, causal, q scale): S = 1, at and past one tile, ragged, past 32 tiles;
# q x 8 moves the running max across key tiles (alpha far from 1)
FLASH_CASES = [(FLASH_SHAPE, True, 1.0), ((2, 16, 8, 100, 128), True, 1.0),
               ((1, 16, 8, 4097, 128), True, 1.0), ((2, 4, 2, 100, 16), True, 1.0),
               ((1, 6, 2, 300, 16), True, 1.0), ((1, 16, 8, 1, 128), True, 1.0),
               ((2, 16, 8, 128, 128), True, 1.0), ((2, 16, 8, 129, 128), False, 1.0),
               ((1, 16, 8, 4097, 128), True, 8.0), ((2, 8, 2, 300, 16), False, 8.0)]
DECODE_SHAPE = (4, 16, 8, 4352, 128)  # B, H, KV, T, D of the serve decode
DECODE_POS = (0, 255, 4095, 4351)
# the RWKV6 path: rwkv6-7b at full width, serving
SERVE_RWKV = dict(arch="rwkv6-7b", batch=4, prompt_len=4096, tokens=128, seed=0)
SERVE_RWKV_PARAMS = 7_534_546_944
# decode at pos 4,096 vs the last-token logits of a 4,097-token prefill. The
# recurrence's step is float32 on both paths (decode in PyTorch from the
# kernel's final state; the kernel's last, ragged chunk), so the gap comes
# from the GEMMs (4 rows against 16,388) and, in bf16, the activations'
# roundings, carried through 32 layers of the reference's high-gain init. On
# an H100: 0.03125 in float32 weights on two prompts (one bf16 ulp at
# |logit| 4-8; 54 of 262,144 logits over one ulp) and 0.125 in bf16; the
# bounds are about 3x those. A wrong state, token shift or decay moves the
# logits by their whole scale.
SERVE_RWKV_DECODE_VS_PREFILL_BF16 = 0.4
SERVE_RWKV_DECODE_VS_PREFILL_F32 = 0.1
# the linear-scan kernel against its plain versions: float32 sums in other
# orders, held against the output's scale max(1, max |want|). Measured 6.0e-6
# on an H100 (against the chunked scan; its own error against a float64
# result reaches 1e-5 of the scale at chunks of 64 on the CPU, the step
# form's 2e-7)
SCAN_TOL = 3e-5
SCAN_SHAPE = (4, 4096, 64, 64)  # B, T, H, K of the serve prefill
LOG_DECAY_CLIP = (-8.0, 4.0)  # logw = -exp(clip(., -8, 4)) in the model


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


def _bound(moved_bytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the given rate (float32 by default), whichever is
    larger."""
    bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return {
        "bytes_moved": moved_bytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def _bits_equal(a, b) -> bool:
    """Bitwise equality (a -0 differs from a +0)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
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


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (a float32 tensor)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def _gap(got, want, tol: float, ulp: bool):
    """(max |got - want|, passes): each element within ``tol`` plus, with
    ``ulp``, one bfloat16 ulp of the larger magnitude."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    bound = tol + (_bf16_ulp(torch.maximum(g.abs(), w.abs())) if ulp else 0.0)
    return d.max().item(), bool((d <= bound).all())


def _same_argmax(a, b) -> float:
    """The share of rows whose greedy token is the same in two logits."""
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def _serve_run(model, prompt, steps, cache_len):
    """The port's prefill, then teacher-forced decode steps; every logits."""
    logits, cache = model.prefill({"tokens": prompt, "cache_len": cache_len})
    out = [logits.cpu()]
    for i, tok in enumerate(steps):
        logits, cache = model.decode_step(
            cache, {"token": tok, "pos": prompt.shape[1] + i}
        )
        out.append(logits.cpu())
    return out


def _count_kinds(cfg, kind: str) -> int:
    return sum(b.kind == kind for g in cfg.groups for b in g.blocks * g.repeat)


def phase_lm_agree(lm, kmods):
    """The LMs at their reduced configs: card (kernels) against CPU (plain
    versions), same weights, float32 and bf16."""
    import copy

    import torch

    configs = lm["configs"]
    lm["device"].resolve_device("cuda")  # TF32 off: float32 products in full float32
    lm_kernels = [kmods[k] for k in ("flash_attention", "decode_attention", "rwkv6_scan")]
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, reduced=True)
        n_attn, n_time = _count_kinds(cfg, "attn"), _count_kinds(cfg, "rwkv6_time")
        base = configs.build_model(cfg, device="cpu", seed=0)
        for dtype in (torch.float32, torch.bfloat16):
            cpu = copy.deepcopy(base).to(dtype)
            gpu = copy.deepcopy(cpu).to("cuda")
            for P, cache_len in LM_AGREE_CASES:
                rng = np.random.default_rng(P)
                prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, P), dtype=np.int32))
                steps = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32))
                         for _ in range(LM_AGREE_STEPS)]
                want = _serve_run(cpu, prompt, steps, cache_len)
                before = [fn.LAUNCHES for fn in lm_kernels]
                got = _serve_run(gpu, prompt, steps, cache_len)
                launched = [fn.LAUNCHES - n for fn, n in zip(lm_kernels, before)]
                _require(launched == [n_attn, n_attn * LM_AGREE_STEPS, n_time],
                         f"{arch}: launches {launched}")
                f32 = dtype == torch.float32
                worst = 0.0
                for i, (g, w) in enumerate(zip(got, want)):
                    d, ok = _gap(g, w, 1e-5 if f32 else LM_BF16_TOL, ulp=f32)
                    _require(ok and bool(torch.isfinite(g.float()).all()),
                             f"lm_agree {arch} {dtype} P={P} step {i}: max |d| {d}")
                    worst = max(worst, d)
                out[f"{arch}/{str(dtype)[6:]}/P{P}"] = worst
    _emit({"phase": "lm_agree", "steps": LM_AGREE_STEPS, "cases": list(LM_AGREE_CASES),
           "tolerance": {"float32": "one bf16 ulp + 1e-5", "bfloat16": LM_BF16_TOL},
           "max_abs_logit_diff": out})


def _profile(fn):
    """fn's result, and the device time by kernel over that one call of
    ``fn`` (torch.profiler), the wall time and the device's busy share of
    it; None where the profiler shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}  # device activities only (kernels, copies): host ops would count twice
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us, n = by_kernel.get(e.key[:80], (0.0, 0))
        by_kernel[e.key[:80]] = (us + e.self_device_time_total, n + e.count)
    total_us = sum(us for us, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return value, {
        "wall_s": wall, "device_s": total_us / 1e6 if total_us else None,
        "device_busy_share": total_us / 1e6 / wall if total_us else None,
        "top_kernels_ms": {k: [us / 1e3, n] for k, (us, n) in top},
    }


def _share(prof, tag: str):
    """The share of a profile's device time spent in kernels whose name
    holds ``tag`` (among its ten largest kinds); None without device time."""
    if not prof["device_s"]:
        return None
    ms = sum(t for k, (t, _) in prof["top_kernels_ms"].items() if tag in k)
    return ms / (prof["device_s"] * 1e3)


def phase_serve(lm, kmods, name, spec, n_params_want, bounds):
    """An LM path at full width through the user's entry points:
    build_model, then serve_lm.generate (prefill, greedy decode). Each
    kernel runs as often as the arch's layers say: flash attention once per
    attention layer, flash-decode once per attention layer and decode step,
    the linear scan once per time-mix layer (prefill only), the others
    never. ``bounds``: the decode-vs-prefill bounds (bf16, float32)."""
    import torch

    configs, serve_lm = lm["configs"], lm["serve_lm"]
    cfg = configs.get_config(spec["arch"])
    B, P, n_new = spec["batch"], spec["prompt_len"], spec["tokens"]
    t0 = time.perf_counter()
    model = configs.build_model(cfg, device="cuda", seed=spec["seed"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    _require(n_params == model.num_params() == n_params_want, f"{name}: {n_params} parameters")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt = serve_lm.prompt_tokens(cfg.vocab, B, P, spec["seed"])
    n_attn = _count_kinds(cfg, "attn")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kmods)
    res = serve_lm.generate(model, prompt, n_new)
    launches = {k: fn.LAUNCHES for k, fn in kmods.items()}
    peak = torch.cuda.max_memory_allocated()
    want = dict(dict.fromkeys(kmods, 0), flash_attention=n_attn,
                decode_attention=n_attn * (n_new - 1), rwkv6_scan=_count_kinds(cfg, "rwkv6_time"))
    _require(launches == want, f"{name}: launches {launches}, expected {want}")
    toks = res["tokens"]
    _require(tuple(toks.shape) == (B, n_new) and int(toks.min()) >= 0
             and int(toks.max()) < cfg.vocab, f"{name}: tokens out of range")
    for key in ("prefill_logits", "first_step_logits"):
        lg = res[key]
        _require(tuple(lg.shape) == (B, 1, cfg.vocab) and bool(torch.isfinite(lg.float()).all()),
                 f"{name}: {key} not finite or of the wrong shape")
    steps = n_new - 1

    # decode at pos P against the last-token logits of a prefill of P + 1
    # tokens, in bf16 (the served model), profiled, then in float32 weights
    full = torch.cat([prompt, toks[:, :1]], dim=1)
    ref_bf16, prefill_prof = _profile(lambda: model.prefill({"tokens": full})[0])
    d_bf16 = (res["first_step_logits"].float() - ref_bf16.float()).abs().max().item()
    same_bf16 = _same_argmax(res["first_step_logits"], ref_bf16)
    # device time of 8 steady decode steps (slots of the cache reused)
    cache, tok = res.pop("cache"), toks[:, -1:].to(model.device)
    pos = torch.tensor(P + n_new - 8, dtype=torch.int32, device=model.device)

    def decode8():
        nonlocal cache
        for _ in range(8):
            _, cache = model.decode_step(cache, {"token": tok, "pos": pos})
            pos.add_(1)

    _, decode_prof = _profile(decode8)
    del cache, res["prefill_logits"]
    m32 = model.float()  # in place: each bf16 weight is freed once converted
    del model
    # the served prompt with its first greedy token, and a second prompt
    # (P + 1 tokens from the next seed): two readings of the float32 gap
    second = serve_lm.prompt_tokens(cfg.vocab, B, P + 1, spec["seed"] + 1)
    d_f32, same_f32, over_ulp = [], [], []
    for seq in (full, second):
        _, cache32 = m32.prefill({"tokens": seq[:, :P], "cache_len": P + 1})
        step32, _ = m32.decode_step(cache32, {"token": seq[:, P:], "pos": P})
        del cache32
        ref32, _ = m32.prefill({"tokens": seq})
        s32, r32 = step32.float(), ref32.float()
        d_f32.append((s32 - r32).abs().max().item())
        same_f32.append(_same_argmax(step32, ref32))
        over_ulp.append(((s32 - r32).abs()
                         > _bf16_ulp(torch.maximum(s32.abs(), r32.abs()))).sum().item())
    del m32
    torch.cuda.empty_cache()
    out = {
        "phase": name, "arch": cfg.name, "params": n_params, "weight_bytes": weight_bytes,
        "batch": B, "prompt_len": P, "new_tokens": n_new, "decode_steps": steps,
        "launches": launches, "build_model_s": build_s,
        "prefill_s": res["prefill_s"], "prefill_tokens_per_s": B * P / res["prefill_s"],
        "decode_s": res["decode_s"], "decode_ms_per_step": res["decode_s"] / steps * 1e3,
        "decode_tokens_per_s": B * steps / res["decode_s"],
        "max_memory_allocated": peak,
        "decode_vs_prefill_max_abs": {"bf16": d_bf16, "float32_copy": d_f32},
        "decode_vs_prefill_tolerance": {"bf16": bounds[0], "float32_copy": bounds[1]},
        "decode_vs_prefill_same_argmax": {"bf16": same_bf16, "float32_copy": same_f32},
        "decode_vs_prefill_float32_over_one_ulp": [over_ulp, B * cfg.vocab],
        "first_tokens": toks[0, :8].tolist(),
        "profile_prefill_4097": prefill_prof, "profile_decode_8_steps": decode_prof,
        "prefill_flash_attention_share": _share(prefill_prof, "flash_fwd"),
    }
    _emit(out)  # the numbers first, so that a failing check shows them
    _require(d_bf16 <= bounds[0], f"{name}: decode vs prefill (bf16) {d_bf16}")
    _require(max(d_f32) <= bounds[1], f"{name}: decode vs prefill (float32) {d_f32}")
    return out


def _attn_inputs(B, H, KV, S, D, dtype, seed, qscale=1.0):
    """q (B, H, S, D) and k, v (B, KV, S, D) as transposed views of
    (B, S, heads, D) tensors, as the model passes them; q scaled by
    ``qscale`` (large logits move the running max across key tiles)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn((B, S, h, D), generator=g, device="cuda").mul(qscale if i == 0 else 1.0)
        .to(dtype).transpose(1, 2)
        for i, h in enumerate((H, KV, KV))
    )


def _attn_check(got, want, dtype, what):
    import torch

    # bf16: one rounding apart, so within one bf16 ulp, plus the float32
    # tolerance for outputs near 0, where bf16 keeps float32's noise
    d, ok = _gap(got, want, ATTN_F32_TOL, ulp=dtype == torch.bfloat16)
    _require(ok, f"{what}: kernel != plain, max |d| {d}")
    return d


def _flash_bf16_check(got, q, k, v, causal, fref, what):
    """The bf16 flash kernel against the plain version and the plain tiled
    version: |got - want| <= 2**-7 * attn(q, k, |v|) + one bf16 ulp of the
    larger magnitude + 2e-5, elementwise. Returns, for each, max |d|, the
    largest share of the bound, and the count of elements and the largest
    number of bf16 ulps by which |d| - 2e-5 exceeds two ulps (a tighter,
    ulp-only bound would fail there)."""
    import torch

    g = got.float()
    attn_abs = fref.flash_attention_ref(q.float(), k.float(), v.float().abs(), causal=causal)
    out = {}
    for name, plain in (("plain", fref.flash_attention_ref),
                        ("tiled", fref.flash_attention_tiled_ref)):
        w = plain(q, k, v, causal=causal).float()
        ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
        d = (g - w).abs()
        share = (d / (FLASH_BF16_P_ROUNDING * attn_abs + ulp + ATTN_F32_TOL)).max().item()
        _require(share <= 1.0, f"{what}: kernel != {name} version, max |d| {d.max().item()}, "
                               f"{share} of the bound")
        ulps = (d - ATTN_F32_TOL).clamp_min(0) / ulp
        out[name] = (d.max().item(), share, int((ulps > 2).sum().item()), ulps.max().item())
        del w, ulp, d, ulps
    return out


def _decode_graph_check(dops, dref):
    """A CUDA graph of one decode call at the serve shape (bf16), replayed
    with each of DECODE_POS written into its pos tensor in place: every
    replay bitwise equal to the eager call and within one bf16 ulp + 2e-5 of
    the plain version. Returns the largest max |d|."""
    import torch

    q, k, v = _attn_inputs(*DECODE_SHAPE, dtype=torch.bfloat16, seed=7)
    q = q[:, :, 0]
    pos = torch.tensor(0, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        dops.decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dops.decode(q, k, v, pos)
    worst = 0.0
    for p in DECODE_POS:
        pos.fill_(p)
        graph.replay()
        eager = dops.decode(q, k, v, torch.tensor(p, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        what = f"decode graph replay pos={p}"
        _require(_bits_equal(out, eager), f"{what}: replay != eager call")
        worst = max(worst, _attn_check(out, dref.decode_ref(q, k, v, pos), torch.bfloat16, what))
    return worst


def phase_kernel_attn(fops, fref, dops, dref):
    """The attention kernels against their plain versions at the serve
    shapes and ragged ones; times, bounds and the SDPA yardstick."""
    import torch
    import torch.nn.functional as F

    err = {"flash_attention": {}, "decode_attention": {}}
    f32_worst = 0.0
    # max |d|, share of the bound, elements beyond two ulps (summed), most ulps
    bf16_worst = {"plain": (0.0, 0.0, 0, 0.0), "tiled": (0.0, 0.0, 0, 0.0)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for i, (shape, causal, qscale) in enumerate(FLASH_CASES):
            q, k, v = _attn_inputs(*shape, dtype=dtype, seed=i, qscale=qscale)
            got = fops.attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            what = f"flash {name} {shape} causal={causal} q x {qscale}"
            _require(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
            if dtype == torch.float32:
                want = fref.flash_attention_ref(q, k, v, causal=causal)
                f32_worst = max(f32_worst, _attn_check(got, want, dtype, what))
                del want
            else:
                for plain, (d, sh, n, u) in _flash_bf16_check(got, q, k, v, causal, fref,
                                                              what).items():
                    d0, sh0, n0, u0 = bf16_worst[plain]
                    bf16_worst[plain] = (max(d0, d), max(sh0, sh), n0 + n, max(u0, u))
            del got
    err["flash_attention"] = {"float32": f32_worst}
    for plain, key in (("plain", "bfloat16"), ("tiled", "bfloat16_vs_tiled")):
        d, sh, n, u = bf16_worst[plain]
        err["flash_attention"].update({key: d, f"{key}_share_of_bound": sh,
                                       f"{key}_beyond_2_ulps": n, f"{key}_max_ulps": u})
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        worst = 0.0
        B, H, KV, T, D = DECODE_SHAPE
        cases = [(DECODE_SHAPE, p) for p in DECODE_POS]
        cases += [((2, 16, 8, 1000, 128), 999), ((2, 16, 8, 1000, 128), 500),
                  ((2, 4, 2, 300, 16), 299), ((1, 24, 8, 700, 16), 5000)]
        for i, ((B, H, KV, T, D), p) in enumerate(cases):
            q, k, v = _attn_inputs(B, H, KV, T, D, dtype=dtype, seed=100 + i)
            q = q[:, :, 0]
            pos = torch.tensor(p, dtype=torch.int32, device="cuda")
            got = dops.decode(q, k, v, pos)
            again = dops.decode(q, k, v, pos)
            want = dref.decode_ref(q, k, v, pos)
            torch.cuda.synchronize()
            what = f"decode {name} T={T} pos={p}"
            worst = max(worst, _attn_check(got, want, dtype, what))
            _require(_bits_equal(got, again), f"{what}: two calls differ")
        err["decode_attention"][name] = worst
    err["decode_attention"]["graph_replay_bfloat16"] = _decode_graph_check(dops, dref)

    # times in bf16, the served dtype, at the serve shapes
    bf16 = torch.bfloat16
    size = 2
    B, H, KV, S, D = FLASH_SHAPE
    q, k, v = _attn_inputs(*FLASH_SHAPE, dtype=bf16, seed=0)
    lib = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True), 5, 3)
    flash = {
        "shape": list(FLASH_SHAPE), **_device_ms(lambda: fops.attention(q, k, v), 5, 3),
        "plain_ms": _time_ms(lambda: fref.flash_attention_ref(q, k, v), iters=3, warmup=1),
        "library": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
        "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
        **_bound((2 * B * H * S * D + 2 * B * KV * S * D) * size,
                 4 * B * H * D * S * (S + 1) / 2, BF16_FLOPS_PER_S),
    }
    flash["achieved_tflop_s"] = flash["flops"] / (flash["ms"] * 1e-3) / 1e12
    flash["share_of_bound"] = flash["bound_ms"] / flash["ms"]
    flash["ms_over_library_ms"] = flash["ms"] / flash["library_ms"]
    del q, k, v
    B, H, KV, T, D = DECODE_SHAPE
    q, k, v = _attn_inputs(*DECODE_SHAPE, dtype=bf16, seed=1)
    q = q[:, :, 0]
    p = DECODE_POS[-1]
    pos = torch.tensor(p, dtype=torch.int32, device="cuda")
    mask = (torch.arange(T, device="cuda") <= p)[None, None, None, :]
    lib = _device_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                              enable_gqa=True))
    # the wrapper's n_splits for this card, and the other candidate (one CTA
    # an SM against two)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_splits = dops.choose_splits(B, KV, n_sm)
    alt = dops.choose_splits(B, KV, n_sm, ctas_per_sm=3 - dops.CTAS_PER_SM)
    decode = {
        "shape": list(DECODE_SHAPE), "pos": p, **_device_ms(lambda: dops.decode(q, k, v, pos)),
        "plain_ms": _time_ms(lambda: dref.decode_ref(q, k, v, pos), iters=5),
        "library": "scaled_dot_product_attention(attn_mask=keys <= pos, enable_gqa=True)",
        "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
        **_bound((2 * B * KV * (p + 1) * D + 2 * B * H * D) * size, 4 * B * H * (p + 1) * D,
                 BF16_FLOPS_PER_S),
        "n_splits": n_splits, "sm_count": n_sm, "other_n_splits": alt,
        "other_n_splits_ms": _device_ms(lambda: dops.decode(q, k, v, pos, n_splits=alt))["ms"],
    }
    decode["achieved_gb_s"] = decode["bytes_moved"] / (decode["ms"] * 1e-3) / 1e9
    decode["share_of_bound"] = decode["bound_ms"] / decode["ms"]
    decode["ms_over_library_ms"] = decode["ms"] / decode["library_ms"]
    res = {"phase": "kernel_attn", "max_abs_err": err,
           "tolerance": {"float32": ATTN_F32_TOL, "bfloat16": "one bf16 ulp + 2e-5",
                         "flash_bfloat16": "2**-7 * attn(q, k, |v|) + one bf16 ulp + 2e-5"},
           "timings": {"flash_attention": flash, "decode_attention": decode}}
    _emit(res)
    return res


def _scan_inputs(B, T, H, dtype, seed, state=False, strided=False):
    """r, k, v (B, T, H, 64) in ``dtype`` (with ``strided``, transposed views
    of (B, H, T, 64) tensors), log-decays over the model's whole clip range
    with both edges, a nonzero bonus u, and an initial state or None."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, H, T, 64) if strided else (B, T, H, 64)
    r, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
    if strided:
        r, k, v = (a.transpose(1, 2) for a in (r, k, v))
    lo, hi = LOG_DECAY_CLIP
    logw = -torch.exp(torch.rand((B, T, H, 64), generator=g, device="cuda") * (hi - lo) + lo)
    logw.view(-1)[:2] = torch.tensor([-math.exp(hi), -math.exp(lo)], device="cuda")
    u = torch.randn((H, 64), generator=g, device="cuda") * 0.5
    s0 = torch.randn((B, H, 64, 64), generator=g, device="cuda") if state else None
    return r, k, v, logw, u, s0


def _scan_gap(got, got_s, want, want_s):
    """(max |d| of out, max |d| of out and state over their scales
    max(1, max |want|), passes): out within SCAN_TOL of its scale plus, in
    bf16, one bf16 ulp (one rounding of the float32 result); the state
    within SCAN_TOL of its scale."""
    import torch

    d = (got.float() - want).abs()
    scale, scale_s = max(1.0, want.abs().max().item()), max(1.0, want_s.abs().max().item())
    if got.dtype == torch.bfloat16:
        bound = SCAN_TOL * scale + _bf16_ulp(torch.maximum(got.float().abs(), want.abs()))
    else:
        bound = SCAN_TOL * scale
    d_s = (got_s - want_s).abs().max().item()
    ok = bool((d <= bound).all()) and d_s <= SCAN_TOL * scale_s
    return d.max().item(), max(d.max().item() / scale, d_s / scale_s), ok


def phase_kernel_scan(sops, sref):
    """The linear-scan kernel against both plain versions, the step oracle
    and the chunked scan (the CPU path), at the serve shape and ragged ones;
    times and the bound in bf16 at the serve shape."""
    import torch

    B, T, H, _ = SCAN_SHAPE
    cases = [  # (B, T, H, initial state, strided)
        (B, T, H, False, False), (2, 1, 4, True, False), (2, 100, 4, True, True),
        (1, 4097, 4, True, False), (2, 300, 1, False, False),
    ]
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        worst_abs, worst_rel = 0.0, {"step": 0.0, "chunked": 0.0}
        for i, (b, t, h, state, strided) in enumerate(cases):
            r, k, v, logw, u, s0 = _scan_inputs(b, t, h, dtype, seed=10 + i, state=state,
                                                strided=strided)
            got, got_s = sops.rwkv6_scan(r, k, v, logw, u, 16, s0)
            for plain, (want, want_s) in (
                ("step", sref.rwkv6_ref(r, k, v, logw, u, s0)),
                ("chunked", sref.rwkv6_chunked(r, k, v, logw, u, 16, s0)),
            ):
                torch.cuda.synchronize()
                d_abs, d_rel, ok = _scan_gap(got, got_s, want, want_s)
                _require(ok, f"rwkv6_scan {name} {(b, t, h)} vs {plain}: max |d| {d_abs}, "
                             f"{d_rel} of the scale")
                worst_abs = max(worst_abs, d_abs)
                worst_rel[plain] = max(worst_rel[plain], d_rel)
            del got, got_s, want, want_s
        err[name] = {"max_abs": worst_abs, "max_over_scale": worst_rel}

    # times in bf16, the served dtype, at the serve shape
    bf16, size = torch.bfloat16, 2
    B, T, H, K = SCAN_SHAPE
    r, k, v, logw, u, _ = _scan_inputs(B, T, H, bf16, seed=0)
    n = B * T * H * K
    timing = {
        "shape": list(SCAN_SHAPE),
        **_device_ms(lambda: sops.rwkv6_scan(r, k, v, logw, u, 16), 5, 3),
        "plain_ms": _time_ms(lambda: sref.rwkv6_chunked(r, k, v, logw, u, 16), iters=2, warmup=1),
        "plain": "ref.rwkv6_chunked, chunks of 16 (the CPU path)",
        "library_ms": None, "library": "none: no single PyTorch call computes the RWKV6 recurrence",
        # r, k, v and out in bf16, logw float32, u, the float32 final state;
        # per token and head 5*K*V flops of readout and update, plus the bonus
        **_bound(4 * n * size + n * 4 + H * K * 4 + B * H * K * K * 4,
                 B * T * H * (5 * K * K + 3 * K + 2 * K)),
    }
    timing["share_of_bound"] = timing["bound_ms"] / timing["ms"]
    res = {"phase": "kernel_scan", "cases": len(cases) * 2, "max_err": err,
           "tolerance": {"float32": f"{SCAN_TOL} of the scale",
                         "bfloat16": f"{SCAN_TOL} of the scale + one bf16 ulp"},
           "timings": {"rwkv6_scan": timing}}
    _emit(res)
    return res


def _ptxas_kernels(so, rename):
    """Per kernel of a library, from its build log (ptxas -v): registers,
    stack, spills and static shared memory; ``rename`` turns a mangled name
    into a short one."""
    import re

    kernels, name = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = rename(m.group(1))
            kernels[name] = {}
        elif name and "bytes stack frame" in line:
            st, ss, sl = (int(x) for x in re.findall(r"(\d+) bytes", line)[:3])
            kernels[name].update(stack_bytes=st, spill_store_bytes=ss, spill_load_bytes=sl)
        elif name and "Used" in line and "registers" in line:
            kernels[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return kernels


def _flash_build_facts(fops, build):
    """The flash library as built: per kernel, ptxas's facts, its dynamic
    shared memory, and the HGMMA (wgmma) and HMMA (mma.sync) instructions in
    the library's SASS (cuobjdump)."""
    import re
    import shutil

    def rename(mangled):
        name = re.sub(r".*?(flash_fwd\w*?)I(f?)Li(\d+)E.*", r"\1<\2\3>", mangled)
        return name.replace("<f", "<float, ")

    so = build.library_path(fops._SRC)
    kernels = _ptxas_kernels(so, rename)
    lib = fops.build()
    for dtype, key in ((0, "flash_fwd<float, {}>"), (1, "flash_fwd_wgmma<{}>")):
        for d in fops.HEAD_DIMS:
            kernels.setdefault(key.format(d), {})["dynamic_smem_bytes"] = (
                lib.flash_attention_smem_bytes(dtype, d))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return {"library": so.name, "kernels": kernels,
            "sass_hgmma": len(re.findall(r"\bHGMMA\b", sass)),
            "sass_hmma": len(re.findall(r"\bHMMA\b", sass))}


def _decode_build_facts(dops, build):
    """The decode library as built: per instantiation decode_attn<type, D,
    kG>, ptxas's facts and the ring's dynamic shared memory."""
    import re

    def rename(mangled):
        m = re.search(r"(decode_attn)I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
        if not m:
            return mangled
        dtype = "float" if m.group(2) == "f" else "bf16"
        return f"{m.group(1)}<{dtype}, {m.group(3)}, {m.group(4)}>"

    so = build.library_path(dops._SRC)
    kernels = _ptxas_kernels(so, rename)
    ring = dops.build().decode_attention_smem_bytes()
    for facts in kernels.values():
        facts["dynamic_smem_bytes"] = ring
    return {"library": so.name, "kernels": kernels}


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
    from repro_torch import configs, data, device, fl, serve_lm, telemetry
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ipls_aggregate import ops, ref
    from repro_torch.kernels.linear_scan import ops as sops
    from repro_torch.kernels.linear_scan import ref as sref
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
        "flash_attention": fops.attention,
        "decode_attention": dops.decode,
        "rwkv6_scan": sops.rwkv6_scan,
    }
    lm = {"configs": configs, "device": device, "serve_lm": serve_lm}
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
    libs = {"ipls_aggregate": ops, "quantize": qops, "flash_attention": fops,
            "decode_attention": dops, "linear_scan": sops}
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:  # one nvcc per source, at once
        futs = {k: pool.submit(timed_build, mod) for k, mod in libs.items()}
        build_s = {k: f.result() for k, f in futs.items()}
    flash_built = _flash_build_facts(fops, _build)
    decode_built = _decode_build_facts(dops, _build)
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_library_s": build_s,
           "flash_attention": flash_built, "decode_attention": decode_built})
    _require(flash_built["sass_hgmma"] > 0, "no HGMMA in the flash library's SASS")

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
    phase_lm_agree(lm, kmods)
    serve = phase_serve(lm, kmods, "serve", SERVE, SERVE_PARAMS,
                        (SERVE_DECODE_VS_PREFILL_BF16, SERVE_DECODE_VS_PREFILL_F32))
    serve_rwkv = phase_serve(lm, kmods, "serve_rwkv", SERVE_RWKV, SERVE_RWKV_PARAMS,
                             (SERVE_RWKV_DECODE_VS_PREFILL_BF16, SERVE_RWKV_DECODE_VS_PREFILL_F32))
    kern = phase_kernel(ops, ref)
    kern_q = phase_kernel_q(qops, qref, ops, ref)
    kern_attn = phase_kernel_attn(fops, fref, dops, dref)
    kern_scan = phase_kernel_scan(sops, sref)

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
    fa = kern_attn["max_abs_err"]["flash_attention"]
    rows += [
        # flash: its bf16 cases (the served and timed dtype) against the plain version
        ("flash_attention", "flash_attention/csrc/flash_attention.cu",
         "kernels/flash_attention/flash_attention.py:74", serve, fa["bfloat16"],
         kern_attn["timings"]["flash_attention"],
         {"max_abs_err_of": "bfloat16", "err_share_of_tolerance": fa["bfloat16_share_of_bound"]}),
        # decode: its float32 cases (the bf16 ones within one bf16 ulp)
        ("decode_attention", "decode_attention/csrc/decode_attention.cu",
         "kernels/decode_attention/decode_attention.py:67", serve,
         kern_attn["max_abs_err"]["decode_attention"]["float32"],
         kern_attn["timings"]["decode_attention"],
         {"max_abs_err_of": "float32",
          "share_of_bound": kern_attn["timings"]["decode_attention"]["share_of_bound"]}),
    ]
    rows.append(("rwkv6_scan", "linear_scan/csrc/linear_scan.cu",
                 "kernels/linear_scan/linear_scan.py:77", serve_rwkv,
                 kern_scan["max_err"]["float32"]["max_abs"], kern_scan["timings"]["rwkv6_scan"]))
    _emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
        "replaces": f"src/repro/{replaces}", "path": path["phase"],
        "launches": path["launches"][name], "max_abs_err": err, "ms": tm["ms"],
        "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": tm["library_ms"], **dict(*extra),
    } for name, source, replaces, path, err, tm, *extra in rows]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
