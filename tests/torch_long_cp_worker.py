"""Worker processes for ``test_torch_long_cp.py``: the long-context decode
(``kv_seq`` over ("data", "model"), past 100,000 cache slots) on a gloo mesh
of CPU processes, against the port in one process and the JAX reference's
logits, which the parent hands over. Imports neither JAX nor a test file,
so that spawned workers start fast.

``run(rank, world, shape, out_dir, ref_path)`` is the spawn entry: each rank
joins a gloo group through a file store in ``out_dir`` and builds the mesh
(data, model) = ``shape``. For gemma3-, zamba2- and rwkv6-reduced in
float32 (the model built on the mesh, seeded as the parent's), it builds
``build_decode_step`` at ``ShapeSpec("long", 131072, 1, "decode")`` (the
long-context rules), cuts the reference's cache (drawn by the parent,
carried into the port's layout) into the rank's share as the step declares
it (``arg_shapes``: 131,072 / N slots of each full cache and ring, N the
data x model ranks; Mamba2's and RWKV6's states by heads over "model"),
and runs the decode steps at ``POSITIONS`` (a pos that leaves every slice
but the first empty, each side of the group's boundaries at 2 and 4
ranks, the last two slots) against the same steps in one process from the
whole cache:

* the logits within 1e-5 of max(1, |value|) or one bf16 ulp where two
  float32 runs round apart (counted), as ``torch_tp_worker._logit_gap``;
  zamba2's (its Mamba2 blocks amplify float32 rounding past a bf16 ulp
  between any two float32 runs: 0.037 at a logit of 0.19 on (2, 1)) by
  the float64 rule with the noise rule's factor: no farther from the
  one-process run with float64 weights than NOISE times the one-process
  float32 run, plus one bf16 ulp of the largest and 1e-5;
* the caches afterwards, gathered whole, by the float32 noise rule against
  the one-process run with float64 weights (``torch_tp_worker._noise_bound``;
  zamba2's with the floor of ``_cache_gaps``);
* the reference's logits: within one bf16 ulp of the larger + 1e-5; zamba2's
  by the float64 rule (no farther from the reference's float64 run than
  its own float32 run, plus one bf16 ulp of the step's largest and 1e-5),
  as ``test_torch_long_context.py`` holds the one-process port;
* a prefill built at the long-context shape (PROMPT tokens into T slots):
  its logits by the same rules, and its caches, which it returns in the
  decode layout, gathered whole by the float32 noise rule;
* the parent's arithmetic, each rank's share decoded as if it were the
  whole cache (what a "model" axis of 1 did before), differs on some rank
  from the one-process logits by more than those bounds at pos 100 (where
  a later rank's slice holds none of the valid keys): the fault the
  context-parallel group repairs.

It writes its largest gaps and flags to ``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import copy
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_decode_step
from repro_torch.models.convert import load_jax_cache
from repro_torch.tree import tree_leaves, tree_unflatten

import torch_tp_worker as tw

ARCHS = ("gemma3-1b", "zamba2-1.2b", "rwkv6-7b")
F64_WITNESSED = ("zamba2-1.2b",)
T = 131_072
POSITIONS = (100, 32_767, 32_768, 65_535, 65_536, T - 2, T - 1)
PROMPT = 16  # a long-context prefill's prompt (into T slots)
F32_FLOOR = 1e-5


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def model_of(arch, mesh=None):
    """The reduced model in float32 from the parent's seed."""
    return build_model(get_config(arch, reduced=True), device="cpu", seed=len(arch),
                       mesh=mesh).float()


def _reference_gaps(arch, i, got, r, gaps) -> None:
    got = got.double().numpy()[:, 0]
    want = r["logits32"][i]
    if arch in F64_WITNESSED:
        w64 = r["logits64"][i]
        bound = np.abs(want - w64).max() + bf16_ulp(np.abs(w64).max()) + F32_FLOOR
        tw._note(gaps, f"{arch}/ref_logits_of_float64_bound",
                 float(np.abs(got - w64).max() / bound), 1.0)
        return
    d = np.abs(got - want)
    tw._note(gaps, f"{arch}/ref_logits_of_ulp_bound",
             float((d / (bf16_ulp(np.maximum(abs(got), abs(want))) + F32_FLOOR)).max()), 1.0)


def check_arch(arch, mesh, r, gaps):
    tp = model_of(arch, mesh)
    one, one64 = model_of(arch), model_of(arch).double()
    whole = load_jax_cache(one, r["cache"])
    # the float64 run's cache in its declared dtypes (Mamba2's and RWKV6's
    # states stay float32)
    whole64 = tree_unflatten(whole, [t.to(d.dtype, copy=True) for t, d in zip(
        tree_leaves(whole), tree_leaves(one64.cache_defs(1, T)))])
    dec = build_decode_step(tp, mesh, ShapeSpec("long", T, 1, "decode"))
    assert dec.rules["kv_seq"] == ("data", "model")
    specs = dec.in_shardings[1]
    local = psh.map_specs(lambda t, sp: psh.shard(t, sp, mesh).clone(), whole, specs)
    for t, want in zip(tree_leaves(local), tree_leaves(dec.arg_shapes[1])):
        assert tuple(t.shape) == want.shape, (arch, tuple(t.shape), want.shape)
    # the parent's arithmetic: the rank's share decoded as if whole
    parent = copy.deepcopy(local)
    for i, (pos, tok) in enumerate(zip(POSITIONS, r["tokens"])):
        batch = {"token": torch.from_numpy(tok), "pos": torch.tensor(pos, dtype=torch.int32)}
        logits, local = dec.fn(local, batch)
        one_logits, whole = one.decode_step(whole, batch)
        with tw._Float64Attention():
            logits64, _ = one64.decode_step(whole64, batch)
        if arch in F64_WITNESSED:
            got, own, w64 = (t.double().numpy() for t in (logits, one_logits, logits64))
            bound = (tw.NOISE * np.abs(own - w64).max() + bf16_ulp(np.abs(w64).max())
                     + F32_FLOOR)
            tw._note(gaps, f"{arch}/logits_of_float64_bound",
                     float(np.abs(got - w64).max() / bound), 1.0)
        else:
            tw._logit_gap(logits, one_logits, gaps, f"{arch}/logits")
        _reference_gaps(arch, i, logits, r, gaps)
        if i == 0 and psh.mesh_axis_size(mesh, "model") == 1:
            wrong, _ = one.decode_step(parent, batch)
            d = (wrong.double() - one_logits.double()).abs()
            bound = tw.TOL * one_logits.double().abs().clamp_min(1.0) + tw._ulp_bf16(one_logits)
            beyond = torch.tensor([float((d > bound).any())])
            dist.all_reduce(beyond, op=dist.ReduceOp.MAX)
            gaps[f"{arch}/parent_layout_wrong_at_pos{pos}"] = int(beyond.item())
    _cache_gaps(arch, psh.gather_tree(local, specs, mesh, ("data", "model")), whole, whole64,
                gaps, f"{arch}/cache")


def _cache_gaps(arch, got, one, one64, gaps, key):
    """Each cache leaf (gathered whole) by the float32 noise rule; zamba2's
    (``F64_WITNESSED``) with the largest one-process gap over its leaves as
    the noise's floor: its Mamba2 blocks carry one block's float32
    rounding into the next one's input, so a leaf whose own one-process
    gap is small can still differ by another leaf's (a convolution history
    of the second Mamba2 block, 4.1e-5 from float64 on (1, 2) against a
    one-process gap of 8.1e-6 there, 3.2e-5 and more elsewhere)."""
    leaves = list(zip(tree_leaves(got), tree_leaves(one), tree_leaves(one64)))
    floor = max(tw._gap(b, c) for _, b, c in leaves) if arch in F64_WITNESSED else 0.0
    for a, b, c in leaves:
        assert a.shape == b.shape, (arch, tuple(a.shape), tuple(b.shape))  # the layout's
        tw._noise_bound(a, b, c, gaps, key, floor=floor)


def check_prefill(arch, mesh, gaps):
    """A prefill built at a long-context shape (its rules' cache layout:
    ``kv_seq`` over ("data", "model")) of PROMPT tokens into a cache of T
    slots, against the one-process prefill: its logits (as the decode's),
    the caches it returns in that layout (``out_shardings``), gathered
    whole, by the float32 noise rule against the one-process run with
    float64 weights."""
    from repro_torch.launch.steps import build_prefill_step

    tp, one, one64 = model_of(arch, mesh), model_of(arch), model_of(arch).double()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, tp.cfg.vocab, (1, PROMPT)).astype(np.int32))
    pre = build_prefill_step(tp, mesh, ShapeSpec("long", T, 1, "prefill"))
    specs = pre.out_shardings[1]
    logits, cache = pre.fn({"tokens": tokens, "cache_len": T})
    one_logits, want = one.prefill({"tokens": tokens, "cache_len": T})
    with tw._Float64Attention():
        logits64, want64 = one64.prefill({"tokens": tokens, "cache_len": T})
    if arch in F64_WITNESSED:
        got, own, w64 = (t.double().numpy() for t in (logits, one_logits, logits64))
        bound = tw.NOISE * np.abs(own - w64).max() + bf16_ulp(np.abs(w64).max()) + F32_FLOOR
        tw._note(gaps, f"{arch}/prefill_logits_of_float64_bound",
                 float(np.abs(got - w64).max() / bound), 1.0)
    else:
        tw._logit_gap(logits, one_logits, gaps, f"{arch}/prefill_logits")
    _cache_gaps(arch, psh.gather_tree(cache, specs, mesh, ("data", "model")), want, want64,
                gaps, f"{arch}/prefill_cache")


def run(rank, world, shape, out_dir, ref_path):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        gaps: dict = {}
        for arch in ARCHS:
            check_arch(arch, mesh, ref[arch], gaps)
            check_prefill(arch, mesh, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
