"""Worker processes for ``test_torch_tp_attn.py`` and
``test_torch_tp_attn_reference.py``: the attention variants over a "model"
mesh axis above 1 (MLA in deepseek-reduced, with its MoE layers; M-RoPE and
qkv biases in qwen2-vl-reduced; sliding windows, qk-norm, the embedding
scale and the tied table in gemma3-reduced) on a gloo mesh of CPU
processes, against the port in one process and, where the parent hands
over the reference's results, against the JAX reference on one device.
Imports neither JAX nor a test file, so that spawned workers start fast.

``run(rank, world, shape, out_dir, ref_path)`` is the spawn entry: each rank
joins a gloo group through a file store in ``out_dir``, builds the mesh
(data, model) = ``shape`` and, for each config of ``CASES[shape]`` in
float32, checks

* the init: the rank's shards equal the same slices of the one-process
  draw, bit for bit;
* one ``build_train_step`` step (AdamW, clipping at 1, ``accum_steps=2``
  but 1 for qwen2-vl (``accum_steps``), the arch's ``TRAIN_OVERRIDES``:
  fsdp for deepseek and qwen2-vl) against the same step in one process, on
  the model-axis-1 mesh path (``torch_fsdp_worker.emulated_loss``: each
  data rank's rows, so that the MoE layers take their capacity and
  load-balance loss per data rank as on the mesh), with the dense
  tensor-parallel bounds (``torch_tp_worker``): the metrics by the float32
  noise rule (no farther from the one-process step with float64 weights
  than NOISE times the float32 step, at least 1e-5 of max(1, |value|), as
  the MoE tests hold them); the gradients (AdamW's first moments,
  gathered) by that rule on the scale of the largest and within
  GRAD_LEAF_TOL of each leaf's own largest; the parameters within 1e-5 of
  max(1, |value|) plus PARAM_LR of the learning rate, but where an
  element's gradient is float32 noise (below GRAD_LEAF_TOL of its leaf's
  largest), which AdamW's first step moves by a share of the learning rate
  whatever its size, within NOISE_LR of it;
* ``build_prefill_step`` (qwen2-vl with positions3 that are not the token
  positions) and 8 ``build_decode_step`` steps against the one-process
  model: logits within 1e-5 of max(1, |value|) or one bf16 ulp where two
  float32 products round to two sides of a bf16 boundary (counted); the
  caches (gathered over "model": full caches, gemma3's rings, MLA's latent
  and k_rope) by the float32 noise rule against the one-process run with
  float64 weights;
* with ``ref_path`` (a pickle the parent wrote from the reference; a data
  axis of 1): the reference's params in the rank's shards (deepseek's
  lossless copy: every MoE capacity at all the choices), its train step's
  loss within 1e-5 relative, parameters and first moments within REF_TOL
  of each leaf's largest (deepseek's router apart, within the MoE family's
  REF_ROUTER_TOL; elements whose gradient is float32 noise within NOISE_LR
  of the learning rate, as above), its prefill's and decode steps' logits
  within one bf16 ulp + 1e-5;
* on (1, 2), deepseek's reference-layout tree into the shards and back
  (``convert``), and a checkpoint saved on the mesh equal to one process's
  save, each way (``torch_tp_worker.check_convert_and_checkpoint``), bit
  for bit.

gemma3-reduced's windowed layers keep rings of 8 slots, which do not split
over 3 ranks: on (1, 3) they stay whole beside full caches split over the
ranks' slots (``gemma3-ring8``, a mixed layout: ``check_mixed_layout``),
and the sequence-parallel windowed path over split rings runs on a copy
with a 6-slot window (``gemma3-window6``). It writes its largest gaps to ``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.launch.steps import (TRAIN_OVERRIDES, build_decode_step, build_prefill_step,
                                      build_train_step)
from repro_torch.models.convert import gather_params, load_jax_params, to_reference_layout
from repro_torch.models.sharding_hooks import activation_sharding
from repro_torch.optim import adamw
from repro_torch.tree import named_leaves, tree_leaves

import torch_fsdp_worker as fw
import torch_tp_worker as tw

ARCHS = ("deepseek-v2-lite-16b", "gemma3-1b", "qwen2-vl-72b")
CASES = {(1, 2): ARCHS, (2, 2): ARCHS,
         (1, 3): ("deepseek-v2-lite-16b", "qwen2-vl-72b", "gemma3-window6")}
REF_CASES = {(1, 2): ARCHS, (1, 3): ("deepseek-v2-lite-16b", "qwen2-vl-72b", "gemma3-window6")}
B, S, T, STEPS = tw.B, tw.S, tw.T, tw.STEPS
TOL, NOISE, LR = tw.TOL, tw.NOISE, tw.LR
REF_TOL = tw.REF_TOL          # against the reference: of a leaf's largest
REF_ROUTER_TOL = 5e-3         # the MoE family's bound on the router (test_torch_tp_moe.py)
NOISE_LR = 1.0                # AdamW's first step at a noise gradient: of the learning rate


def config(name: str, lossless: bool = False, get=get_config):
    """A reduced config by arch id, or ``gemma3-window6``: gemma3-reduced
    with 6-slot windows (rings that split over 2 and 3 ranks). With
    ``lossless`` every MoE capacity at all the choices. ``get`` is the
    package's ``get_config`` (the reference's takes the same edits)."""
    if name == "gemma3-window6":
        cfg = get("gemma3-1b", reduced=True)
        cfg = _map_blocks(cfg, lambda b: b if b.kind != "attn" or b.attn.window is None else
                          dataclasses.replace(b, attn=dataclasses.replace(b.attn, window=6)))
        return dataclasses.replace(cfg, name="gemma3-window6")
    cfg = get(name, reduced=True)
    if lossless:
        cfg = _map_blocks(cfg, lambda b: b if b.kind != "moe" else dataclasses.replace(
            b, moe=dataclasses.replace(b.moe, capacity_factor=b.moe.num_experts / b.moe.top_k)))
    return cfg


def _map_blocks(cfg, fn):
    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, blocks=tuple(fn(b) for b in g.blocks)) for g in cfg.groups))


def _arch(name: str) -> str:
    return "gemma3-1b" if name.startswith("gemma3") else name


def accum_steps(cfg) -> int:
    """Two microbatches, but one for M-RoPE: the train step (as the
    reference's) cuts every batch leaf on its dim 0 into microbatches,
    which for positions3 (3, B, S) is the component axis (ROADMAP.md
    queue 3)."""
    return 1 if cfg.mrope else 2


def step_config(name: str):
    return psh.IplsStepConfig(grad_clip=1.0, accum_steps=accum_steps(config(name)),
                              **TRAIN_OVERRIDES.get(_arch(name), {}))


def positions3(seed: int, S: int = S):
    """M-RoPE ids (3, B, S) that are not the token positions: t the
    position, h and w drawn (an image's rows and columns)."""
    rng = np.random.default_rng(seed)
    p = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    p[1:] = rng.integers(0, S, (2, B, S))
    return torch.from_numpy(p)


def train_batch(cfg, tokens, mask=None):
    batch = {"tokens": tokens, "participation": torch.ones(B) if mask is None else mask}
    if cfg.mrope:
        batch["positions3"] = positions3(4, tokens.shape[1])
    return batch


def serve_batch(cfg, tokens, rows=slice(None), T: int = T):
    batch = {"tokens": tokens[rows], "cache_len": T}
    if cfg.mrope:
        batch["positions3"] = positions3(5, tokens.shape[1])[:, rows]
    return batch


def _one_ctx():
    return activation_sharding(fw.OneRank(), make_rules(fw.OneRank(), "train"))


def check_init(name, mesh, gaps, cfg=None):
    """The rank's shards: the same slices of the one-process draw, bit for
    bit (``cfg``: the config, by default ``config(name)``); the count of
    leaves "model" splits."""
    cfg = cfg or config(name)
    one = build_model(cfg, device="cpu", seed=0)
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh)
    want = psh.shard_tree(one.params(), tp.param_specs, mesh)
    for (leaf, a), (_, b) in zip(named_leaves(tp.params()), named_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b), leaf
    gaps[f"{name}/init_split_leaves"] = sum(
        a.numel() < b.numel() for a, b in zip(tree_leaves(tp.params()), tree_leaves(one.params())))


def check_train(name, mesh, gaps, cfg=None, step_cfg=None, flips=None, key=None, batch=None,
                one_loss=None, leaf_tol=lambda leaf: tw.GRAD_LEAF_TOL, noise_lr=NOISE_LR):
    """One AdamW step on the mesh against the one-process step (the
    model-axis-1 mesh path, each data rank's rows), gathered: the bounds
    with which ``torch_tp_worker._train_case`` holds the dense LMs
    (``cfg`` and ``step_cfg`` by default ``config(name)`` and
    ``step_config(name)``; the gaps under ``key``, by default
    ``name + "/train"``). ``flips`` (``torch_tp_ssm_worker.LogitGradients``)
    records the gradients in the bf16 logits of both float32 steps, and
    the gradients' noise rule takes their measured difference
    (``flips.share``) as a floor of the noise beside the float64 run's.
    ``batch`` (by default ``train_batch``'s), ``one_loss(model, D)``, the
    one-process loss (by default ``torch_fsdp_worker.emulated_loss``), and
    ``leaf_tol(leaf name)``, the per-leaf bound (GRAD_LEAF_TOL; None for a
    leaf whose exact gradient is 0, held by the first rule alone, its own
    largest being float noise, and its parameters within 2 lr: AdamW's
    first step moves each by lr in the direction of its noise's sign) and
    ``noise_lr``, the bound on the elements of noise gradients (NOISE_LR),
    serve whisper's checks (``torch_tp_whisper_worker``)."""
    cfg = cfg or config(name)
    D = psh.mesh_axis_size(mesh, "data")
    opt = adamw(LR, wd=0.1)
    step_cfg = step_cfg or step_config(name)
    batch = batch or train_batch(cfg, tw._tokens(256, 1, (B, S)))
    one_loss = one_loss or fw.emulated_loss
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    built = build_train_step(tp, mesh, ShapeSpec("t", batch["tokens"].shape[1], B, "train"),
                             optimizer=opt, step_cfg=step_cfg)
    record = flips.recording if flips is not None else (lambda side: contextlib.nullcontext())
    with record("mesh"):
        state, m = built.fn(built.init_state(tp.params()), batch)

    def one_step(dtype):
        one = build_model(cfg, device="cpu", seed=0).to(dtype)
        step = psh.make_train_step(one_loss(one, D), opt,
                                   psh.IplsStepConfig(grad_clip=1.0,
                                                      accum_steps=step_cfg.accum_steps),
                                   num_agents=D)
        return step(psh.init_state(one.params(), opt), batch)

    with record("one"):
        one_state, one_m = one_step(torch.float32)
    with tw._Float64Attention():  # RWKV6's scan in float64 too
        state64, m64 = one_step(torch.float64)
    key = key or f"{name}/train"
    share = flips.share(mesh) if flips is not None else 0.0
    if flips is not None:
        gaps[f"{key}/logit_gradient_flip_share"] = share
    for k in one_m:  # the gradient's norm moves with the gradients
        fw._noise_bound(m[k], one_m[k], m64[k], gaps, f"{key}/metric_{k}",
                        floor=share if k == "grad_norm" else 0.0)
    # the first moments, gathered whole over every axis
    whole_m = psh.gather_tree(state.opt_state,
                              psh._opt_specs(state.opt_state, built.update_shardings), mesh,
                              ("model", "data"))
    rows = [(n, a, b, c) for (n, a), b, c in zip(named_leaves(whole_m),
                                                 tree_leaves(one_state.opt_state),
                                                 tree_leaves(state64.opt_state))
            if n.endswith(".m")]
    scale = max(float(b.abs().max()) for _, _, b, _ in rows)
    for n, a, b, c in rows:
        assert a.shape == b.shape
        tw._noise_bound(a / scale, b / scale, c / scale, gaps, f"{key}/gradients", floor=share)
        if leaf_tol(n) is None:  # float noise alone: no scale of its own
            continue
        own = max(float(b.abs().max()), 1e-30)
        tw._note(gaps, f"{key}/gradients_of_leaf", tw._gap(a / own, b / own), leaf_tol(n))
    params = psh.gather_tree(state.params, built.update_shardings, mesh, ("model", "data")) \
        if step_cfg.fsdp else gather_params(tp)
    # AdamW's first step moves an element by lr g / (|g| + eps): where the
    # gradient is float32 noise (below GRAD_LEAF_TOL of its leaf's largest,
    # g near eps) any two summation orders move it by a share of the
    # learning rate (the one-process float32 step lies up to a third of it
    # from float64 there), so such elements are held to NOISE_LR of it
    for (_, a), b, c, (n, _, g1, g64) in zip(named_leaves(params),
                                             tree_leaves(one_state.params),
                                             tree_leaves(state64.params), rows):
        d = (a.double() - b.double()).abs() - TOL * b.double().abs().clamp_min(1.0)
        noise = g64.double().abs() < tw.GRAD_LEAF_TOL * float(g64.abs().max())
        if leaf_tol(n) is None:
            # every element's gradient is noise, whose sign AdamW's first
            # step follows by a whole lr g / |g|: either way
            tw._note(gaps, f"{key}/params_of_zero_gradient_leaves_over_lr",
                     max(float(d.max()), 0.0) / LR, 2.0)
            continue
        beyond = max(float(torch.where(noise, 0.0, d).max()), 0.0) / LR
        tw._note(gaps, f"{key}/params_beyond_tol_over_lr", beyond, tw.PARAM_LR)
        tw._note(gaps, f"{key}/params_beyond_tol_over_lr_noise_gradients",
                 max(float(torch.where(noise, d, 0.0).max()), 0.0) / LR, noise_lr)
        gaps[f"{key}/params_noise"] = max(gaps.get(f"{key}/params_noise", 0.0), tw._gap(b, c))


def check_serve(name, mesh, gaps, cfg=None, S=S, T=T, n_steps=STEPS, float64_logits=False):
    """A prefill of S tokens and ``n_steps`` decode steps over a cache of T
    slots (by default 12, 24 and 8) on the mesh against the one-process
    model (``cfg``: by default ``config(name)``): logits, and the caches
    gathered over "model" by the float32 noise rule. With
    ``float64_logits`` (zamba2: its blocks amplify float32 rounding past
    one bf16 ulp between two float32 runs, ROADMAP.md queue 3) the logits
    are held by the float64 rule of ``check_reference``: no farther from
    the one-process run with float64 weights than the one-process float32
    run, plus one bf16 ulp of the step's largest and 1e-5."""
    cfg = cfg or config(name)
    one = build_model(cfg, device="cpu", seed=0).float()
    one64 = build_model(cfg, device="cpu", seed=0).double()
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    rows = tw._rows(mesh)
    tokens = tw._tokens(256, 2, (B, S))

    def held(got, one_l, l64, what):
        if not float64_logits:
            tw._logit_gap(got, one_l, gaps, f"{name}/{what}_logits")
            return
        l64 = l64.double()
        bound = (float((one_l.double() - l64).abs().max()) + float(tw._ulp_bf16(l64.abs().max()))
                 + 1e-5)
        tw._note(gaps, f"{name}/{what}_logits_of_float64_bound",
                 float((got.double() - l64).abs().max()) / bound, 1.0)

    pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
    logits, cache = pre.fn(serve_batch(cfg, tokens, T=T))
    with _one_ctx():
        one_logits, one_cache = one.prefill(serve_batch(cfg, tokens, rows, T))
        with tw._Float64Attention():
            logits64, cache64 = one64.prefill(serve_batch(cfg, tokens, rows, T))
    held(logits, one_logits, logits64, "prefill")
    for a, b, c in zip(tree_leaves(tw._gather_cache(cache, pre, mesh)), tree_leaves(one_cache),
                       tree_leaves(cache64)):
        tw._noise_bound(a, b, c, gaps, f"{name}/prefill_cache")
    dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
    steps = tw._tokens(256, 3, (n_steps, B, 1))
    for t in range(n_steps):
        logits, cache = dec.fn(cache, {"token": steps[t], "pos": S + t})
        with _one_ctx():
            one_logits, one_cache = one.decode_step(one_cache, {"token": steps[t][rows],
                                                                "pos": S + t})
            with tw._Float64Attention():
                logits64, _ = one64.decode_step(cache64, {"token": steps[t][rows], "pos": S + t})
        held(logits, one_logits, logits64, "decode")
    for a, b, c in zip(tree_leaves(tw._gather_cache(cache, pre, mesh)), tree_leaves(one_cache),
                       tree_leaves(cache64)):
        tw._noise_bound(a, b, c, gaps, f"{name}/decode_cache")


def check_mixed_layout(mesh, gaps):
    """gemma3-reduced's 8-slot rings on a model axis of 3, whose slots do
    not split over it, beside full caches of 24 slots that do (a mixed
    layout): the rings stay whole on every rank (the reference's spec),
    the full caches split over the ranks' slots, and the prefill and 8
    decode steps, each layer in its own layout, hold to the one-process
    model (``check_serve``)."""
    cfg = config("gemma3-1b")
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
    # the slots' entry of each cache leaf's spec: the full caches' "model",
    # the rings' None
    kv_seq = {spec[1] for layer in pre.out_shardings[1]["g0"] for entry in layer.values()
              for spec in entry.values()}
    assert kv_seq == {"model", None}, kv_seq
    gaps["gemma3-ring8/mixed_layout"] = 1
    check_serve("gemma3-ring8", mesh, gaps, cfg=cfg)


def check_reference(name, mesh, ref, gaps, cfg=None, step_cfg=None, S=S, T=T, n_steps=STEPS,
                    noise_lr=NOISE_LR):
    """The reference's params in the rank's shards; its one-device train
    step, prefill of S tokens and ``n_steps`` decode steps' logits over a
    cache of T slots (float32) against the mesh's (``cfg`` and ``step_cfg``
    by default ``config(name, lossless=True)`` and ``step_config(name)``;
    ``noise_lr`` the bound on the elements of noise gradients, NOISE_LR)."""
    r = ref[name]
    cfg = cfg or config(name, lossless=True)
    opt = adamw(LR, wd=0.1)
    step_cfg = step_cfg or step_config(name)
    tp = load_jax_params(build_model(cfg, device="cpu", seed=0, mesh=mesh).float(), r["params"])
    built = build_train_step(tp, mesh, ShapeSpec("t", S, B, "train"), optimizer=opt,
                             step_cfg=step_cfg)
    batch = train_batch(cfg, torch.from_numpy(r["tokens"]))
    state, m = built.fn(built.init_state(tp.params()), batch)
    tw._note(gaps, f"{name}/ref_loss_rel", abs(float(m["loss"]) - r["loss"]) / abs(r["loss"]),
             1e-5)
    whole = psh.IplsTrainState(
        step=state.step, params=gather_params(tp),
        opt_state=psh.gather_tree(state.opt_state,
                                  psh._opt_specs(state.opt_state, built.update_shardings), mesh,
                                  ("model", "data")),
        eps=state.eps)
    got = dict(named_leaves(to_reference_layout(whole)))
    for leaf, w in r["state"].items():
        if not (leaf.startswith(".params") or (leaf.startswith(".opt_state")
                                               and leaf.endswith(".m"))):
            continue
        w = torch.as_tensor(np.asarray(w)).double()
        d = (got[leaf].double() - w).abs()
        scale = max(float(w.abs().max()), 1e-30)
        what = "ref_params" if leaf.startswith(".params") else "ref_grads"
        if what == "ref_params":
            # AdamW's first step at a noise gradient (the one-process check's
            # rule): a zero-init bias's leaf is lr wide, and such an element
            # moves by a share of it
            g = torch.as_tensor(np.asarray(r["state"][f".opt_state{leaf[7:]}.m"])).double()
            noise = g.abs() < tw.GRAD_LEAF_TOL * float(g.abs().max())
            tw._note(gaps, f"{name}/ref_params_noise_gradients_over_lr",
                     float(torch.where(noise, d - TOL, 0.0).max()) / LR, noise_lr)
            d = torch.where(noise, 0.0, d)
        router = "'router'" in leaf
        tw._note(gaps, f"{name}/{what}{'_router' if router else ''}", float(d.max()) / scale,
                 REF_ROUTER_TOL if router else REF_TOL)
    tp = load_jax_params(build_model(cfg, device="cpu", seed=0, mesh=mesh).float(), r["params"])
    pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
    logits, cache = pre.fn(serve_batch(cfg, torch.from_numpy(r["serve_tokens"]), T=T))
    ulps = [("prefill", logits, r["prefill_logits"])]
    dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
    for t in range(n_steps):
        logits, cache = dec.fn(cache, {"token": torch.from_numpy(r["steps"][t]), "pos": S + t})
        ulps.append(("decode", logits, r["decode_logits"][t]))
    for i, (what, got_l, want) in enumerate(ulps):
        want = torch.from_numpy(want).double()
        if "prefill_logits64" in r:
            # the float64 rule (zamba2: its blocks amplify float32 rounding
            # past one bf16 ulp between any two float32 runs, ROADMAP.md
            # queue 3): no farther from the reference's float64 run than its
            # own float32 run, plus one bf16 ulp of the step's largest and 1e-5
            w64 = torch.from_numpy(r["prefill_logits64"] if i == 0
                                   else r["decode_logits64"][i - 1]).double()
            bound = (float((want - w64).abs().max()) + float(tw._ulp_bf16(w64.abs().max()))
                     + 1e-5)
            tw._note(gaps, f"{name}/ref_{what}_logits_of_float64_bound",
                     float((got_l.double() - w64).abs().max()) / bound, 1.0)
            continue
        tw._note(gaps, f"{name}/ref_{what}_logits_ulps",
                 float(((got_l.double() - want).abs() / (tw._ulp_bf16(want) + 1e-5)).max()), 1.0)


def run(rank, world, shape, out_dir, ref_path=None):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        shape = tuple(shape)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        gaps: dict = {}
        if ref_path is not None:
            with open(ref_path, "rb") as f:
                ref = pickle.load(f)
            for name in REF_CASES[shape]:
                if name in ref:  # the parent's share of the cases
                    check_reference(name, mesh, ref, gaps)
        else:
            for name in CASES[shape]:
                check_init(name, mesh, gaps)
                check_train(name, mesh, gaps)
                check_serve(name, mesh, gaps)
            if shape == (1, 3):
                check_mixed_layout(mesh, gaps)
            if shape == (1, 2):
                tw.check_convert_and_checkpoint("deepseek-v2-lite-16b", mesh, out_dir, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
