"""Worker processes for ``test_torch_tp_moe.py``: granite-moe-reduced's
routed experts over a "model" mesh axis above 1 on a gloo mesh of CPU
processes, against the model-axis-1 mesh path in one process and, where
the parent hands over the reference's results, against the JAX reference
on one device. Imports neither JAX nor a test file, so that spawned
workers start fast.

``run(rank, world, shape, out_dir, ref_path)`` is the spawn entry: each rank
joins a gloo group through a file store in ``out_dir``, builds the mesh
(data, model) = ``shape`` and, for each config of ``CASES[shape]`` (its
mode: "ffn" with granite's overrides, "expert" with none, "replicated"
where neither dim divides the axis), in float32 checks

* the init: each expert leaf cut for the mode (bit for bit the same slices
  of the one-process draw);
* one ``build_train_step`` step (SGD ``LR``, clip 1) against the same step
  in one process on the model-axis-1 mesh path (``torch_fsdp_worker.
  emulated_loss``: each data rank's rows, the load-balance loss's mean):
  metrics and parameters (gathered) no farther from the one-process step
  with float64 weights than NOISE times the one-process float32 step (at
  least 1e-5 of max(1, |value|)); the router's gradient (its update over
  the learning rate) likewise, on its own (``router_grad``): a
  load-balance term counted once a rank would move it by a share of
  itself;
* ``build_prefill_step`` and 8 ``build_decode_step`` steps against the
  model-axis-1 mesh path in one process: logits within 1e-5 of max(1,
  |value|) or one bf16 ulp where the two runs' float32 products round to
  two sides of a bf16 boundary (counted), the caches (gathered) by the
  float64 noise rule;
* with ``ref_path`` (a pickle the parent wrote from the reference) on a data
  axis of 1: the lossless copy (every MoE capacity at all the choices)
  with the reference's params in the rank's shards: the step's loss within
  1e-5 relative, its gradients within 5e-3 of each leaf's largest (the
  router's recorded apart), and the prefill's and decode's logits within
  one bf16 ulp + 1e-5.

It writes its largest gaps to ``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step
from repro_torch.models import layers as L
from repro_torch.models.convert import gather_params, load_jax_params, to_reference_layout
from repro_torch.models.sharding_hooks import activation_sharding
from repro_torch.optim import sgd
from repro_torch.tree import named_leaves, tree_leaves

import torch_fsdp_worker as fw
import torch_tp_worker as tw

ARCH = "granite-moe-3b-a800m"
CASES = {(1, 2): ("ffn", "expert"), (2, 2): ("ffn",), (1, 3): ("replicated",)}
B, S, T, STEPS = 4, 12, 24, 8
LR = 0.5
TOL = 1e-5
REF_GRAD_TOL = 5e-3  # the MoE family's bound against the reference (test_torch_moe_lm.py)


def config(mode: str, lossless: bool = False):
    """granite-reduced for a mode: its own overrides ("ffn", and on an axis
    that divides neither dim "replicated"), or none ("expert": the default
    rules put the experts on "model"); with ``lossless`` every MoE capacity
    at all the choices."""
    cfg = get_config(ARCH, reduced=True)
    if mode == "expert":
        cfg = dataclasses.replace(cfg, sharding_overrides={})
    if lossless:
        def block(b):
            if b.kind != "moe":
                return b
            return dataclasses.replace(b, moe=dataclasses.replace(
                b.moe, capacity_factor=b.moe.num_experts / b.moe.top_k))

        cfg = dataclasses.replace(cfg, groups=tuple(
            dataclasses.replace(g, blocks=tuple(block(b) for b in g.blocks)) for g in cfg.groups))
    return cfg


def _one_ctx():
    return activation_sharding(fw.OneRank(), make_rules(fw.OneRank(), "train"))


def check_init(mode, mesh, gaps):
    cfg = config(mode)
    one = build_model(cfg, device="cpu", seed=0)
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh)
    want = psh.shard_tree(one.params(), tp.param_specs, mesh)
    for (name, a), (_, b) in zip(named_leaves(tp.params()), named_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b), name
    M = psh.mesh_axis_size(mesh, "model")
    moe = tp.params()["g0"][0]["b1"]["moe"]
    s = cfg.groups[0].blocks[1].moe
    assert L.moe_mode(s, dict(psh.DEFAULT_RULES, **cfg.sharding_overrides), M) == mode
    L._check_moe_slices(moe, s, mode, M)
    gaps[f"{mode}/router_split"] = int(moe["router"].shape[1] < s.num_experts)


def _is_router(name: str) -> bool:
    return "'router'" in name


def check_train(mode, mesh, gaps):
    cfg = config(mode)
    D = psh.mesh_axis_size(mesh, "data")
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    before = gather_params(tp)
    before = [t.clone() for t in tree_leaves(before)]
    built = build_train_step(tp, mesh, ShapeSpec("t", S, B, "train"), optimizer=sgd(LR),
                             step_cfg=psh.IplsStepConfig(grad_clip=1.0))
    batch = {"tokens": tw._tokens(256, 1, (B, S)), "participation": torch.ones(B)}
    state, m = built.fn(built.init_state(tp.params()), batch)
    after = gather_params(tp)

    def one_step(dtype):
        one = build_model(cfg, device="cpu", seed=0).to(dtype)
        step = psh.make_train_step(fw.emulated_loss(one, D), sgd(LR),
                                   psh.IplsStepConfig(grad_clip=1.0), num_agents=D)
        return step(psh.init_state(one.params(), sgd(LR)), batch)

    (one, one_m), (one64, m64) = one_step(torch.float32), one_step(torch.float64)
    for k in one_m:
        fw._noise_bound(m[k], one_m[k], m64[k], gaps, f"{mode}/train_metric_{k}")
    for (name, a), p0, b, c in zip(named_leaves(after), before, tree_leaves(one.params),
                                   tree_leaves(one64.params)):
        fw._noise_bound(a, b, c, gaps, f"{mode}/train_params")
        if _is_router(name):  # the router's gradient, on the scale of its largest
            g, g1, g64 = ((p0.double() - x.double()) / LR for x in (a, b, c))
            scale = max(float(g1.abs().max()), 1e-30)
            fw._noise_bound(g / scale, g1 / scale, g64 / scale, gaps, f"{mode}/router_grad")


def check_serve(mode, mesh, gaps):
    cfg = config(mode)
    one = build_model(cfg, device="cpu", seed=0).float()
    one64 = build_model(cfg, device="cpu", seed=0).double()
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    rows = tw._rows(mesh)
    tokens = tw._tokens(256, 2, (B, S))
    pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
    logits, cache = pre.fn({"tokens": tokens, "cache_len": T})
    with _one_ctx():
        one_logits, one_cache = one.prefill({"tokens": tokens[rows], "cache_len": T})
        with tw._Float64Attention():
            _, cache64 = one64.prefill({"tokens": tokens[rows], "cache_len": T})
    tw._logit_gap(logits, one_logits, gaps, f"{mode}/prefill_logits")
    dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
    steps = tw._tokens(256, 3, (STEPS, B, 1))
    for t in range(STEPS):
        logits, cache = dec.fn(cache, {"token": steps[t], "pos": S + t})
        with _one_ctx():
            one_logits, one_cache = one.decode_step(one_cache, {"token": steps[t][rows],
                                                                "pos": S + t})
            with tw._Float64Attention():
                one64.decode_step(cache64, {"token": steps[t][rows], "pos": S + t})
        tw._logit_gap(logits, one_logits, gaps, f"{mode}/decode_logits")
    for a, b, c in zip(tree_leaves(tw._gather_cache(cache, pre, mesh)), tree_leaves(one_cache),
                       tree_leaves(cache64)):
        tw._noise_bound(a, b, c, gaps, f"{mode}/decode_cache")


def check_reference(mode, mesh, ref, gaps):
    """The lossless copy with the reference's params: its one-device train
    step, prefill and decode logits against the mesh's."""
    cfg = config(mode, lossless=True)
    tp = load_jax_params(build_model(cfg, device="cpu", seed=0, mesh=mesh).float(), ref["params"])
    state0 = psh.IplsTrainState(torch.zeros(()), gather_params(tp), (), torch.zeros(()))
    before = {k: v.clone() for k, v in named_leaves(to_reference_layout(state0).params)}
    built = build_train_step(tp, mesh, ShapeSpec("t", S, B, "train"), optimizer=sgd(LR),
                             step_cfg=psh.IplsStepConfig(grad_clip=1.0))
    batch = {"tokens": torch.from_numpy(ref["tokens"]), "participation": torch.ones(B)}
    _, m = built.fn(built.init_state(tp.params()), batch)
    tw._note(gaps, f"{mode}/ref_loss_rel", abs(float(m["loss"]) - ref["loss"]) / abs(ref["loss"]),
             1e-5)
    state1 = psh.IplsTrainState(torch.zeros(()), gather_params(tp), (), torch.zeros(()))
    after = dict(named_leaves(to_reference_layout(state1).params))
    for name, w in ref["grads"].items():
        g = (before[name].double() - after[name].double()) / LR
        w = torch.from_numpy(w).double()
        key = f"{mode}/ref_router_grads" if _is_router(name) else f"{mode}/ref_grads"
        tw._note(gaps, key, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30),
                 REF_GRAD_TOL)
    # serving, from the reference's params
    tp = load_jax_params(build_model(cfg, device="cpu", seed=0, mesh=mesh).float(), ref["params"])
    pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
    logits, cache = pre.fn({"tokens": torch.from_numpy(ref["serve_tokens"]), "cache_len": T})
    ulps = {"prefill": (logits, torch.from_numpy(ref["prefill_logits"]))}
    dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
    for t in range(STEPS):
        logits, cache = dec.fn(cache, {"token": torch.from_numpy(ref["steps"][t]), "pos": S + t})
        ulps[f"decode{t}"] = (logits, torch.from_numpy(ref["decode_logits"][t]))
    for what, (got, want) in ulps.items():
        ulp = tw._ulp_bf16(want) + 1e-5
        tw._note(gaps, f"{mode}/ref_{'prefill' if what == 'prefill' else 'decode'}_logits_ulps",
                 float(((got.double() - want.double()).abs() / ulp).max()), 1.0)


def run(rank, world, shape, out_dir, ref_path=None):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        shape = tuple(shape)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        ref = None
        if ref_path is not None:
            with open(ref_path, "rb") as f:
                ref = pickle.load(f)
        gaps: dict = {}
        for mode in CASES[shape]:
            check_init(mode, mesh, gaps)
            check_train(mode, mesh, gaps)
            check_serve(mode, mesh, gaps)
            if ref is not None and shape[0] == 1:
                check_reference(mode, mesh, ref, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
