"""Worker processes for ``test_torch_tp.py``: tensor parallelism (a "model"
mesh axis above 1) on a gloo mesh of CPU processes against the port in one
process and, where the parent hands over the reference's results, against
the JAX reference on one device. Imports neither JAX nor a test file, so
that spawned workers start fast.

``run(rank, world, shape, out_dir, ref_path)`` is the spawn entry: each rank
joins a gloo group through a file store in ``out_dir`` (no port), builds
the mesh (data, model) = ``shape``, and for internlm2-reduced and
phi4-mini-reduced (tied) in float32 checks

* the init: the rank's shards equal the same slices of the one-process
  draw, bit for bit;
* one ``build_train_step`` step (AdamW, clipping at 1, ``accum_steps=2``;
  with two data ranks also with data rank 1's agents dropped) against the
  same step in one process: metrics and the owned optimizer slices within
  1e-5 of max(1, |value|); the gradients (AdamW's first moments) on the
  scale of the largest no farther from the step with float64 weights than
  NOISE times the one-process float32 step, and each within GRAD_LEAF_TOL
  of its own largest of the one-process step's; the parameters (gathered)
  within 1e-5 of max(1, |value|) plus PARAM_LR of the learning rate
  (AdamW's first step divides each gradient by its own size, so a
  gradient that is float32 noise moves its element by a visible share of
  the learning rate);
* ``build_prefill_step`` (logits, the caches gathered over "model") and 8
  ``build_decode_step`` steps (logits, then the caches) against the model
  in one process: the logits within 1e-5 of max(1, |value|) or one bf16
  ulp where the runs' float32 products round to two sides of a bf16
  boundary (counted), the caches no farther from the model run with
  float64 weights than NOISE times the one-process float32 run (layer 2's
  keys carry float32 noise of about 1e-4 of their scale, which no two
  summation orders share); and the same with float64 weights on both
  sides within 1e-5 of max(1, |value|);
* with ``ref_path`` (a pickle the parent wrote from the reference): the
  reference's parameters loaded into the rank's shards, its train step's
  loss, parameters and first moments (the gradients) and its prefill and
  decode logits;
* on the (1, 2) mesh, ``convert`` and ``checkpoint`` on the mesh: the
  reference-layout tree into the shards and back bit for bit, a checkpoint
  saved on the mesh restored in one process and one saved in one process
  restored on the mesh, equal to the one-process save.

It writes its largest gaps (and the counts beyond the float32 bound) to
``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step
from repro_torch.models.convert import gather_params, load_jax_params, to_reference_layout
from repro_torch.optim import adamw
from repro_torch.tree import named_leaves, tree_leaves

ARCHS = ("internlm2-1.8b", "phi4-mini-3.8b")
B, S, T, STEPS = 4, 12, 24, 8  # S and T split 2, 3 and 4 ways
TOL = 1e-5                       # float32, relative to max(1, |value|)
REF_TOL = 2e-3                   # against the reference: of a leaf's largest
NOISE = 4                        # float32 leaves: times the one-process float32 run's own gap
PARAM_LR = 0.05                  # AdamW's first step: of the learning rate, beside TOL
GRAD_LEAF_TOL = 1e-3             # a gradient against one process: of the leaf's own largest
LR = 1e-3


def _gap(a, b) -> float:
    """max |a - b| / max(1, |b|), in float64."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    if not a.numel():
        return 0.0
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each |x| (2**(e - 7) for x in [2**e, 2**(e+1)))."""
    x = x.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _logit_gap(got, want, gaps, key) -> None:
    """bf16 logits of float32 products: within TOL of max(1, |value|) plus
    one bf16 ulp, where the runs' float32 products (which differ by float32
    noise) round to two sides of a bf16 boundary; such roundings are
    counted in ``key + "_roundings"``."""
    got, want = got.double(), want.double()
    d = (got - want).abs()
    tol = TOL * want.abs().clamp_min(1.0)
    ulp = torch.maximum(_ulp_bf16(want), _ulp_bf16(got))
    i = int(d.argmax())
    assert bool((d <= tol + ulp).all()), (key, float(d.max()), float(got.flatten()[i]),
                                          float(want.flatten()[i]))
    gaps[key] = max(gaps.get(key, 0.0), float(torch.where(d <= tol, d, 0.0).max()))
    gaps[key + "_roundings"] = gaps.get(key + "_roundings", 0) + int((d > tol).sum())


def _attn64(q, k, v, causal=True, window=None, q_offset=None):
    """Plain attention in q's dtype (float64 here), causal over a sliding
    ``window`` where there is one: the oracle of the float64 run, whose
    kernels' plain versions compute in float32."""
    rep_ = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep_, dim=1), v.repeat_interleave(rep_, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(q.shape[-1])
    if causal:
        i = torch.arange(q.shape[2])[:, None] + (q_offset or 0)
        j = torch.arange(k.shape[2])[None, :]
        hidden = (j > i) | (j <= i - window) if window is not None else j > i
        s = s.masked_fill(hidden, float("-inf"))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1), v)


def _decode64(q, k, v, pos, n_splits=None, slot0=0, return_lse=False):
    """Plain decode in q's dtype, with the partial form's slot offset and
    log-sum-exp."""
    rep_ = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep_, dim=1), v.repeat_interleave(rep_, dim=1)
    s = torch.einsum("bhd,bhtd->bht", q, k) / np.sqrt(q.shape[-1])
    s = s.masked_fill(torch.arange(k.shape[2]) + slot0 > int(pos), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    out = torch.einsum("bht,bhtd->bhd", p, v)
    return (out, lse) if return_lse else out


def _scan64(r, k, v, logw, u, chunk=None, init_state=None):
    """The RWKV6 recurrence step by step in float64 (differentiable): the
    float64 run's scan, whose wrapper and chunked plain version compute in
    float32. Returns (out (B, T, H, K) float64, the final state in float32,
    the cache's dtype)."""
    B, T, H, K = r.shape
    r, k, v, w, u = (a.double() for a in (r, k, v, torch.exp(logw.double()), u))
    S = (torch.zeros((B, H, K, K), dtype=torch.float64) if init_state is None
         else init_state.double())
    outs = []
    for t in range(T):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S)
                    + (rt * u * kt).sum(-1, keepdim=True) * vt)
        S = S * w[:, t, ..., None] + kt[..., :, None] * vt[..., None, :]
    return torch.stack(outs, dim=1), S.float()


class _Float64Attention:
    """The models' attention wrappers replaced by ``_attn64``/``_decode64``,
    and for float64 inputs the RWKV6 scan's wrapper and chunked form by
    ``_scan64``."""

    def __enter__(self):
        from repro_torch.models import layers, ssm

        self.saved = (layers.flash_ops.attention, layers.decode_ops.decode,
                      ssm.scan_ops.rwkv6_scan, ssm.scan_ref.rwkv6_chunked)
        scan, chunked = self.saved[2:]
        layers.flash_ops.attention, layers.decode_ops.decode = _attn64, _decode64
        ssm.scan_ops.rwkv6_scan = lambda r, *a: (_scan64 if r.dtype == torch.float64
                                                 else scan)(r, *a)
        ssm.scan_ref.rwkv6_chunked = lambda r, *a: (_scan64 if r.dtype == torch.float64
                                                    else chunked)(r, *a)

    def __exit__(self, *exc):
        from repro_torch.models import layers, ssm

        (layers.flash_ops.attention, layers.decode_ops.decode, ssm.scan_ops.rwkv6_scan,
         ssm.scan_ref.rwkv6_chunked) = self.saved


def _noise_bound(got, one, one64, gaps, key, floor: float = 0.0) -> None:
    """A float32 leaf of the mesh no farther from the one-process run with
    float64 weights than NOISE times the one-process float32 run (at least
    TOL); its gap to the one-process float32 run is recorded too. ``floor``:
    a noise the two float32 runs are known to carry beside the float64
    run's (the bf16 logits' flips, ``torch_tp_ssm_worker``)."""
    gap = _gap
    noise = max(gap(one, one64), floor)
    gaps[key + "_vs_one"] = max(gaps.get(key + "_vs_one", 0.0), gap(got, one))
    gaps[key + "_noise"] = max(gaps.get(key + "_noise", 0.0), noise)
    _note(gaps, key + "_vs_float64", gap(got, one64), max(TOL, NOISE * noise))


def _note(gaps, key, value, bound) -> None:
    gaps[key] = max(gaps.get(key, 0.0), value)
    assert value <= bound, (key, value, bound)


def _rows(mesh):
    D = psh.mesh_axis_size(mesh, "data")
    d = mesh.get_local_rank("data")
    return slice(d * B // D, (d + 1) * B // D)


def _tokens(vocab, seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32))


def _models(arch, mesh, dtype=torch.float32):
    cfg = get_config(arch, reduced=True)
    one = build_model(cfg, device="cpu", seed=0)
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh)
    return one.to(dtype), tp.to(dtype)


def check_init(arch, mesh, gaps):
    """The rank's shards: the same slices of the one-process draw (bf16)."""
    cfg = get_config(arch, reduced=True)
    one = build_model(cfg, device="cpu", seed=0)
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh)
    want = psh.shard_tree(one.params(), tp.param_specs, mesh)
    for (name, a), (_, b) in zip(named_leaves(tp.params()), named_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b), name
    split = sum(a.numel() < b.numel() for a, b in zip(tree_leaves(tp.params()),
                                                        tree_leaves(one.params())))
    gaps[f"{arch}/init_split_leaves"] = split


def _train_case(arch, mesh, mask, gaps, key):
    cfg = get_config(arch, reduced=True)
    one, tp = _models(arch, mesh)
    one64 = build_model(cfg, device="cpu", seed=0).double()
    opt = adamw(LR, wd=0.1)
    step_cfg = psh.IplsStepConfig(grad_clip=1.0, accum_steps=2)
    D = psh.mesh_axis_size(mesh, "data")
    batch = {"tokens": _tokens(256, 1, (B, S)), "participation": torch.from_numpy(mask)}
    built = build_train_step(tp, mesh, ShapeSpec("tp", S, B, "train"), optimizer=opt,
                             step_cfg=step_cfg)
    state, m = built.fn(built.init_state(tp.params()), batch)

    def one_step(model):
        step = psh.make_train_step(model.loss, opt, step_cfg, num_agents=D)
        return step(psh.init_state(model.params(), opt), batch)

    one_state, one_m = one_step(one)
    state64, _ = one_step(one64)
    for k in one_m:
        _note(gaps, f"{key}/metric_{k}", _gap(m[k], one_m[k]), TOL)
    # the owned optimizer slices: the one-process state's slices under the
    # ZeRO-1 specs over every axis (the "model" shard, then the data slice)
    opt_specs = psh._opt_specs(one_state.opt_state, built.update_shardings)

    def owned(opt_state):
        return psh.map_specs(lambda t, sp: psh.shard(t, sp, mesh), opt_state, opt_specs)

    rows = [(n, a, b, c) for (n, a), b, c in zip(named_leaves(state.opt_state),
                                                 tree_leaves(owned(one_state.opt_state)),
                                                 tree_leaves(owned(state64.opt_state)))]
    # the first moments are (1 - b1) times the clipped gradients: on the
    # scale of the largest over every leaf (the slices this rank owns) by
    # the float32 noise rule, and each on the scale of its own largest
    # within GRAD_LEAF_TOL, so that a leaf of small gradients off by a
    # whole factor (an all-reduce too many or too few) fails too; the
    # smallest (the last layer's q and k at init, 1e-7 against 1e-3) are
    # float32 noise of their cancelling softmax terms, about 1e-4 of
    # their own largest apart
    scale = max(float(b.abs().max()) for n, _, b, _ in rows if n.endswith(".m"))
    for name, a, b, c in rows:
        assert a.shape == b.shape
        _note(gaps, f"{key}/opt_owned", _gap(a, b), TOL)
        if name.endswith(".m"):
            _noise_bound(a / scale, b / scale, c / scale, gaps, f"{key}/gradients")
            own = max(float(b.abs().max()), 1e-30)
            _note(gaps, f"{key}/gradients_of_leaf", _gap(a / own, b / own), GRAD_LEAF_TOL)
    # the parameters after AdamW's first step, which divides each gradient
    # by its own size: where a gradient is float32 noise (1e-10 against
    # 1e-2) the two runs move an element by up to a few percent of the
    # learning rate apart, so PARAM_LR of it is allowed beside TOL
    for a, b, c in zip(tree_leaves(gather_params(tp)), tree_leaves(one_state.params),
                       tree_leaves(state64.params)):
        d = (a.double() - b.double()).abs() - TOL * b.double().abs().clamp_min(1.0)
        _note(gaps, f"{key}/params_beyond_tol_over_lr", max(float(d.max()), 0.0) / LR, PARAM_LR)
        gaps[f"{key}/params_noise"] = max(gaps.get(f"{key}/params_noise", 0.0), _gap(b, c))


def check_train(arch, mesh, gaps):
    D = psh.mesh_axis_size(mesh, "data")
    _train_case(arch, mesh, np.ones(B, np.float32), gaps, f"{arch}/train")
    if D > 1:  # data rank 1's agents dropped
        drop = np.ones(B, np.float32)
        drop[B // D:2 * B // D] = 0.0
        _train_case(arch, mesh, drop, gaps, f"{arch}/train_drop")


def _gather_cache(cache, built, mesh):
    """A rank's cache whole over "model" (its slots of the decode layout)."""
    return psh.gather_tree(cache, built.out_shardings[1], mesh)


def check_serve(arch, mesh, gaps):
    one, tp = _models(arch, mesh)
    one64 = build_model(get_config(arch, reduced=True), device="cpu", seed=0).double()
    rows = _rows(mesh)
    tokens = _tokens(256, 2, (B, S))
    pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
    logits, cache = pre.fn({"tokens": tokens, "cache_len": T})
    one_logits, one_cache = one.prefill({"tokens": tokens[rows], "cache_len": T})
    with _Float64Attention():
        _, cache64 = one64.prefill({"tokens": tokens[rows], "cache_len": T})
    _logit_gap(logits, one_logits, gaps, f"{arch}/prefill_logits")
    for a, b, c in zip(tree_leaves(_gather_cache(cache, pre, mesh)), tree_leaves(one_cache),
                       tree_leaves(cache64)):
        _noise_bound(a, b, c, gaps, f"{arch}/prefill_cache")
    dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
    steps = _tokens(256, 3, (STEPS, B, 1))
    for t in range(STEPS):
        logits, cache = dec.fn(cache, {"token": steps[t], "pos": S + t})
        one_logits, one_cache = one.decode_step(one_cache, {"token": steps[t][rows], "pos": S + t})
        with _Float64Attention():
            one64.decode_step(cache64, {"token": steps[t][rows], "pos": S + t})
        _logit_gap(logits, one_logits, gaps, f"{arch}/decode_logits")
    for a, b, c in zip(tree_leaves(_gather_cache(cache, pre, mesh)), tree_leaves(one_cache),
                       tree_leaves(cache64)):
        _noise_bound(a, b, c, gaps, f"{arch}/decode_cache")


def check_serve64(arch, mesh, gaps):
    """Prefill and 8 decode steps with float64 weights (attention through
    the float64 plain forms, the partial decode and the query offset
    included) on the mesh and in one process, within TOL: the norms still
    compute in float32, but far from the float32 run's noise."""
    cfg = get_config(arch, reduced=True)
    one = build_model(cfg, device="cpu", seed=0).double()
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).double()
    rows = _rows(mesh)
    tokens = _tokens(256, 2, (B, S))
    steps = _tokens(256, 3, (STEPS, B, 1))
    with _Float64Attention():
        pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
        logits, cache = pre.fn({"tokens": tokens, "cache_len": T})
        one_logits, one_cache = one.prefill({"tokens": tokens[rows], "cache_len": T})
        _note(gaps, f"{arch}/float64_prefill_logits", _gap(logits, one_logits), TOL)
        dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
        for t in range(STEPS):
            logits, cache = dec.fn(cache, {"token": steps[t], "pos": S + t})
            one_logits, _ = one.decode_step(one_cache, {"token": steps[t][rows], "pos": S + t})
            _note(gaps, f"{arch}/float64_decode_logits", _gap(logits, one_logits), TOL)
    for a, b in zip(tree_leaves(_gather_cache(cache, pre, mesh)), tree_leaves(one_cache)):
        _note(gaps, f"{arch}/float64_decode_cache", _gap(a, b), TOL)


def _leaf_gap(got: dict, want: dict, gaps, key, bound) -> None:
    """Per leaf: max |d| over the leaf's largest |value| (at least 1e-30)."""
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w)).double()
        scale = max(float(w.abs().max()), 1e-30)
        _note(gaps, key, float((got[name].double() - w).abs().max()) / scale, bound)


def check_reference(arch, mesh, ref, gaps):
    """The reference's params in the rank's shards; its train step, prefill
    and decode logits (one device, float32) against the mesh's."""
    r = ref[arch]
    cfg = get_config(arch, reduced=True)
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    load_jax_params(tp, r["params"])
    opt = adamw(LR, wd=0.1)
    step_cfg = psh.IplsStepConfig(grad_clip=1.0, accum_steps=2)
    built = build_train_step(tp, mesh, ShapeSpec("tp", S, B, "train"), optimizer=opt,
                             step_cfg=step_cfg)
    batch = {"tokens": torch.from_numpy(r["tokens"]), "participation": torch.ones(B)}
    state, m = built.fn(built.init_state(tp.params()), batch)
    _note(gaps, f"{arch}/ref_loss_rel", abs(float(m["loss"]) - r["loss"]) / abs(r["loss"]), 1e-5)
    whole = psh.IplsTrainState(
        step=state.step, params=gather_params(tp),
        opt_state=psh.gather_tree(state.opt_state,
                                  psh._opt_specs(state.opt_state, built.update_shardings), mesh),
        eps=state.eps)
    got = {k: v for k, v in named_leaves(to_reference_layout(whole))}
    def pick(tree, prefix, suffix=""):
        return {k: v for k, v in tree.items() if k.startswith(prefix) and k.endswith(suffix)}

    _leaf_gap(pick(got, ".params"), pick(r["state"], ".params"), gaps, f"{arch}/ref_params",
              REF_TOL)
    # AdamW's first moment after one step is (1 - b1) times the clipped gradient
    _leaf_gap(pick(got, ".opt_state", ".m"), pick(r["state"], ".opt_state", ".m"), gaps,
              f"{arch}/ref_grads", REF_TOL)
    # serving, from the reference's params
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    load_jax_params(tp, r["params"])
    rows = _rows(mesh)
    pre = build_prefill_step(tp, mesh, ShapeSpec("p", S, B, "prefill"))
    logits, cache = pre.fn({"tokens": torch.from_numpy(r["serve_tokens"]), "cache_len": T})
    want = torch.from_numpy(r["prefill_logits"])[rows]
    ulp = (_ulp_bf16(want) + 1e-5)
    _note(gaps, f"{arch}/ref_prefill_logits_ulps",
          float(((logits.double() - want.double()).abs() / ulp).max()), 1.0)
    dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
    for t in range(STEPS):
        logits, cache = dec.fn(cache, {"token": torch.from_numpy(r["steps"][t]), "pos": S + t})
        want = torch.from_numpy(r["decode_logits"][t])[rows]
        ulp = (_ulp_bf16(want) + 1e-5)
        _note(gaps, f"{arch}/ref_decode_logits_ulps",
              float(((logits.double() - want.double()).abs() / ulp).max()), 1.0)


def check_convert_and_checkpoint(arch, mesh, out_dir, gaps):
    """The reference-layout tree into the rank's shards and back, bit for
    bit; a checkpoint saved on the mesh equal to a one-process save (and
    restored by one process), and a one-process save restored on the mesh
    equal to the rank's shards."""
    cfg = get_config(arch, reduced=True)
    one = build_model(cfg, device="cpu", seed=5).float()
    tree = {k: v for k, v in to_reference_layout(
        psh.IplsTrainState(step=torch.zeros((), dtype=torch.int32), params=one.params(),
                           opt_state=(), eps=torch.ones(()))).params.items()}
    tree = {k: _numpy_tree(v) for k, v in tree.items()}
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    load_jax_params(tp, tree)
    for (name, a), (_, b) in zip(named_leaves(gather_params(tp)), named_leaves(one.params())):
        assert torch.equal(a, b), name
    specs = tp.param_specs
    mesh_dir, one_dir = os.path.join(out_dir, f"ck_mesh_{arch}"), os.path.join(out_dir, f"ck_one_{arch}")
    ckpt.save_checkpoint(mesh_dir, tp.params(), 7, mesh=mesh, specs=specs)
    if dist.get_rank() == 0:
        ckpt.save_checkpoint(one_dir, one.params(), 7)
    dist.barrier()
    for name in ("shard_0.bin", "index_0.json"):
        with open(os.path.join(mesh_dir, "step_00000007", name), "rb") as f:
            got = f.read()
        with open(os.path.join(one_dir, "step_00000007", name), "rb") as f:
            assert got == f.read(), name
    restored, step = ckpt.restore_checkpoint(mesh_dir, one.params())  # one process reads it
    assert step == 7
    for (name, a), (_, b) in zip(named_leaves(restored), named_leaves(one.params())):
        assert torch.equal(a, b), name
    sliced, _ = ckpt.restore_checkpoint(one_dir, tp.params(), mesh=mesh, specs=specs)
    for (name, a), (_, b) in zip(named_leaves(sliced), named_leaves(tp.params())):
        assert a.shape == b.shape and torch.equal(a, b), name
    gaps[f"{arch}/checkpoint_bitwise"] = 1


def _numpy_tree(x):
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    return x.numpy()


def run(rank, world, shape, out_dir, ref_path=None):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
        ref = None
        if ref_path is not None:
            with open(ref_path, "rb") as f:
                ref = pickle.load(f)
        gaps: dict = {}
        for arch in ARCHS:
            check_init(arch, mesh, gaps)
            check_train(arch, mesh, gaps)
            check_serve(arch, mesh, gaps)
            check_serve64(arch, mesh, gaps)
            if ref is not None:
                check_reference(arch, mesh, ref, gaps)
            if tuple(shape) == (1, 2):
                check_convert_and_checkpoint(arch, mesh, out_dir, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
