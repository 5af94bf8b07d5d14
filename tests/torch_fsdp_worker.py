"""Worker processes for ``test_torch_fsdp.py``: the train step with
``IplsStepConfig(fsdp=True)`` (parameters stored as each rank's "data"
shard, gathered per layer) on a gloo mesh of CPU processes. Imports neither
JAX nor a test file, so that spawned workers start fast.

``run(rank, world, shape, out_dir, ref_path)`` is the spawn entry: each rank
joins a gloo group through a file store in ``out_dir`` (no port), builds the
mesh (data, model) = ``shape`` and, for each arch of ``ARCHS[shape]``
(reduced, float32, SGD ``LR`` with clipping at 1), checks

* the storage: after ``BuiltStep.init_state`` the model's own tensors are
  the state's params, and each leaf with a dim over "data" holds 1/D of its
  "model" shard (the same slice of the one-process draw, bit for bit);
  the others are whole;
* one step with fsdp against the same step without it on the mesh: the
  parameters (gathered whole) and metrics bit for bit where the sums keep
  their order (``bitwise`` records it: a tied table gathered twice, or
  zamba2's shared blocks gathered in every period, sum their gradient's
  pieces in another order, as does a leaf that "model" does not split on
  (2, 2));
* the fsdp step at one microbatch (internlm2 also at two, each piece's
  gradient reduce-scattered before the float32 sum) against the one-process step
  without fsdp (``mesh=None``, num_agents = D): parameters and metrics
  within ``TOL`` of max(1, |value|) of the one-process step with float64
  weights, or NOISE times the float32 step's own gap to it where that is
  larger (whisper-reduced's gain puts 5e-5 of its grad norm between two
  float32 summation orders); with data rank 1's agents dropped for
  internlm2 on (2, 1). deepseek's MoE layers take the mesh path on the mesh
  (capacity and load-balance loss per data rank), so its one-process step
  runs the same arithmetic: each data rank's rows under a model-axis-1 mesh
  context and the load-balance loss's mean over them (``emulated_loss``),
  at one microbatch;
* with ``ref_path`` (a pickle the parent wrote from the reference):
  internlm2 with the reference's float32 params, the fsdp step's loss within
  1e-5 relative of the reference's one-device step, and its parameters and
  gradients (the update over the learning rate) within ``REF_TOL`` of each
  leaf's largest;
* on (2, 1), a checkpoint of the fsdp state (``axes=("model", "data")``)
  restored in one process equal to the gathered state, and that whole state
  saved by one process and restored into a fresh fsdp state equal to the
  mesh's, bit for bit.

It writes its largest gaps and flags to ``out_dir/rank{r}.json``.
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
from repro_torch.launch.steps import build_train_step
from repro_torch.models.convert import load_jax_params, to_reference_layout
from repro_torch.models.sharding_hooks import activation_sharding
from repro_torch.optim import sgd
from repro_torch.tree import named_leaves, tree_leaves

ARCHS = {(2, 1): ("internlm2-1.8b", "deepseek-v2-lite-16b", "whisper-base", "zamba2-1.2b"),
         (2, 2): ("internlm2-1.8b",)}
REF_ARCH = "internlm2-1.8b"
B, S = 4, 16
TOL = 1e-5       # float32, relative to max(1, |value|)
NOISE = 4        # beyond TOL: times the one-process float32 step's own gap to float64
REF_TOL = 2e-3   # against the reference: of a leaf's largest
LR = 0.5
CLIP = 1.0


class OneRank:
    """A (1, 1) mesh's names and shape: the MoE mesh path in one process."""
    mesh_dim_names, shape = ("data", "model"), (1, 1)


def emulated_loss(model, D: int):
    """The loss of D data ranks' mesh paths in one process: each rank's
    rows under a model-axis-1 mesh context (MoE capacity from the rank's
    tokens), the load-balance term replaced by its mean over the ranks, as
    the mesh's ``pmean`` gives it to every rank."""
    c = model.cfg.lb_loss_weight / max(model.cfg.n_layers, 1)

    def rank_rows(batch, d, rows):  # M-RoPE's positions3 (3, B, S) on its dim 1
        sl = slice(d * rows, (d + 1) * rows)
        return {k: v[:, sl] if k == "positions3" else v[sl] for k, v in batch.items()}

    def loss(params, batch):
        rows = batch["tokens"].shape[0] // D
        with activation_sharding(OneRank(), {"batch": "data"}):
            outs = [model.loss(params, rank_rows(batch, d, rows)) for d in range(D)]
        aux = [o[1]["lb_loss"] for o in outs]
        mean = sum(aux) / D
        return torch.cat([pe + c * (mean - a) for (pe, _), a in zip(outs, aux)]), {"lb_loss": mean}

    return loss


def _note(gaps, key, value, bound=None) -> None:
    gaps[key] = max(gaps.get(key, 0.0), value)
    assert bound is None or value <= bound, (key, value, bound)


def _gap(a, b) -> float:
    """max |a - b| / max(1, |b|), in float64."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max()) if a.numel() else 0.0


def _batch(cfg, mask=None, tokens=None):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) if tokens is None else tokens
    batch = {"tokens": torch.from_numpy(toks),
             "participation": torch.from_numpy(np.ones(B, np.float32) if mask is None else mask)}
    if hasattr(cfg, "enc_layers"):
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    return batch


def _model(cfg, mesh):
    tp = psh.model_size(mesh) > 1
    return build_model(cfg, device="cpu", seed=0, mesh=mesh if tp else None).float()


def _mesh_step(cfg, mesh, fsdp, accum=1, mask=None, model=None):
    """One built step on the mesh: (model, built, state, metrics); the
    state's params gathered whole over "data" and "model" as ``whole``."""
    model = model or _model(cfg, mesh)
    built = build_train_step(model, mesh, ShapeSpec("t", S, B, "train"), optimizer=sgd(LR),
                             step_cfg=psh.IplsStepConfig(grad_clip=CLIP, accum_steps=accum,
                                                         fsdp=fsdp))
    state = built.init_state(model.params())
    state, m = built.fn(state, _batch(cfg, mask))
    return model, built, state, m


def _whole(built, params, mesh):
    return psh.gather_tree(params, built.in_shardings[0].params, mesh, ("model", "data"))


def _one_step(cfg, D, accum=1, mask=None, model=None, emulate=False):
    model = model or build_model(cfg, device="cpu", seed=0).float()
    loss = emulated_loss(model, D) if emulate else model.loss
    step = psh.make_train_step(loss, sgd(LR), psh.IplsStepConfig(grad_clip=CLIP,
                                                                 accum_steps=accum),
                               num_agents=D)
    return step(psh.init_state(model.params(), sgd(LR)), _batch(cfg, mask))


def check_storage(arch, mesh, gaps):
    """The fsdp state's params are the model's own tensors, each split leaf
    1/D of its "model" shard (the same slice of the draw)."""
    cfg = get_config(arch, reduced=True)
    D = psh.mesh_axis_size(mesh, "data")
    model, ref = _model(cfg, mesh), _model(cfg, mesh)
    built = build_train_step(model, mesh, ShapeSpec("t", S, B, "train"), optimizer=sgd(LR),
                             step_cfg=psh.IplsStepConfig(fsdp=True))
    state = built.init_state(model.params())
    assert all(a is b for a, b in zip(tree_leaves(state.params), tree_leaves(model.params())))
    specs = psh.tree_leaves_of_specs(built.update_shardings, state.params)
    split = 0
    for p, r, sp, want in zip(tree_leaves(state.params), tree_leaves(ref.params()), specs,
                              tree_leaves(built.arg_shapes[0].params)):
        k = psh.owned_dim(sp)
        assert tuple(p.shape) == want.shape
        if k is None:
            assert torch.equal(p, r)
            continue
        split += 1
        assert p.numel() * D == r.numel()
        n = r.shape[k] // D
        assert torch.equal(p, r.narrow(k, mesh.get_local_rank("data") * n, n))
    gaps[f"{arch}/stored_split_leaves"] = split
    gaps[f"{arch}/leaves"] = len(specs)


def check_against_no_fsdp(arch, mesh, gaps):
    cfg = get_config(arch, reduced=True)
    _, b1, s1, m1 = _mesh_step(cfg, mesh, fsdp=True)
    _, b0, s0, m0 = _mesh_step(cfg, mesh, fsdp=False)
    got, want = _whole(b1, s1.params, mesh), _whole(b0, s0.params, mesh)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want))) and all(
        torch.equal(m1[k], m0[k]) for k in m0)
    gaps[f"{arch}/bitwise_vs_no_fsdp"] = int(same)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        _note(gaps, f"{arch}/vs_no_fsdp", _gap(a, b), TOL)


def _noise_bound(got, one, one64, gaps, key, floor: float = 0.0) -> None:
    """The mesh's value no farther from the one-process step with float64
    weights than NOISE times the one-process float32 step (at least TOL);
    its gap to the float32 step is recorded as ``key``. ``floor``: a noise
    the two float32 steps are known to carry beside the float64 step's
    (``torch_tp_worker._noise_bound``)."""
    noise = max(_gap(one, one64), floor)
    _note(gaps, key, _gap(got, one))
    _note(gaps, key + "_noise", noise)
    _note(gaps, key + "_vs_float64", _gap(got, one64), max(TOL, NOISE * noise))


def check_against_one_process(arch, mesh, gaps, accum, mask=None, key="one"):
    cfg = get_config(arch, reduced=True)
    D = psh.mesh_axis_size(mesh, "data")
    _, built, state, m = _mesh_step(cfg, mesh, fsdp=True, accum=accum, mask=mask)
    emulate = arch.startswith("deepseek")
    one, one_m = _one_step(cfg, D, accum, mask, emulate=emulate)
    one64, m64 = _one_step(cfg, D, accum, mask, emulate=emulate,
                           model=build_model(cfg, device="cpu", seed=0).double())
    for k in one_m:
        _noise_bound(m[k], one_m[k], m64[k], gaps, f"{arch}/{key}_a{accum}_metric_{k}")
    for a, b, c in zip(tree_leaves(_whole(built, state.params, mesh)), tree_leaves(one.params),
                       tree_leaves(one64.params)):
        _noise_bound(a, b, c, gaps, f"{arch}/{key}_a{accum}_params")


def _leaf_gap(got: dict, want: dict, gaps, key, bound) -> None:
    """Per leaf: max |d| over the leaf's largest |value| (at least 1e-30)."""
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w)).double()
        scale = max(float(w.abs().max()), 1e-30)
        _note(gaps, key, float((got[name].double() - w).abs().max()) / scale, bound)


def _ref_names(params) -> dict:
    state = psh.IplsTrainState(torch.zeros(()), params, (), torch.zeros(()))
    return dict(named_leaves(to_reference_layout(state).params))


def check_reference(mesh, ref, gaps):
    """The reference's params in the rank's stored shards; its one-device
    step's loss, parameters and gradients against the fsdp step's."""
    cfg = get_config(REF_ARCH, reduced=True)
    model = load_jax_params(_model(cfg, mesh), ref["params"])
    before = {k: v.clone() for k, v in _ref_names(_whole_of_model(model, mesh)).items()}
    model, built, state, m = _mesh_step(cfg, mesh, fsdp=True, model=model)
    _note(gaps, "ref_loss_rel", abs(float(m["loss"]) - ref["loss"]) / abs(ref["loss"]), 1e-5)
    after = _ref_names(_whole(built, state.params, mesh))
    _leaf_gap(after, ref["params_after"], gaps, "ref_params", REF_TOL)
    grads = {k: (before[k] - after[k]) / LR for k in after}
    _leaf_gap(grads, ref["grads"], gaps, "ref_grads", REF_TOL)


def _whole_of_model(model, mesh):
    if psh.model_size(mesh) == 1:
        return model.params()
    return psh.gather_tree(model.params(), model.param_specs, mesh)


def check_checkpoint(mesh, out_dir, gaps):
    """An fsdp state's checkpoint holds whole leaves: restored in one process
    it is the gathered state; saved by one process, it restores into a
    fresh fsdp state as the mesh's own, bit for bit."""
    cfg = get_config(REF_ARCH, reduced=True)
    _, built, state, _ = _mesh_step(cfg, mesh, fsdp=True)
    specs = built.in_shardings[0]
    axes = ("model", "data")
    mesh_dir, one_dir = os.path.join(out_dir, "ck_fsdp"), os.path.join(out_dir, "ck_one")
    ckpt.save_checkpoint(mesh_dir, state, 1, mesh=mesh, specs=specs, axes=axes)
    whole = psh.gather_tree(state, specs, mesh, axes)
    dist.barrier()
    restored, step = ckpt.restore_checkpoint(mesh_dir, whole)  # one process reads it
    assert step == 1
    for (name, a), (_, b) in zip(named_leaves(restored), named_leaves(whole)):
        assert torch.equal(a, b), name
    if dist.get_rank() == 0:
        ckpt.save_checkpoint(one_dir, restored, 1)
    dist.barrier()
    model = _model(cfg, mesh)
    fresh = build_train_step(model, mesh, ShapeSpec("t", S, B, "train"), optimizer=sgd(LR),
                             step_cfg=psh.IplsStepConfig(fsdp=True))
    like = fresh.init_state(model.params())
    sliced, _ = ckpt.restore_checkpoint(one_dir, like, mesh=mesh, specs=specs, axes=axes)
    for (name, a), (_, b) in zip(named_leaves(sliced), named_leaves(state)):
        assert a.shape == b.shape and torch.equal(a, b), name
    gaps["checkpoint_bitwise"] = 1


def run(rank, world, shape, out_dir, ref_path=None):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        shape = tuple(shape)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        gaps: dict = {}
        for arch in ARCHS[shape]:
            check_storage(arch, mesh, gaps)
            check_against_no_fsdp(arch, mesh, gaps)
            check_against_one_process(arch, mesh, gaps, accum=1)
            if arch == REF_ARCH:
                check_against_one_process(arch, mesh, gaps, accum=2)
        if shape == (2, 1):
            drop = np.ones(B, np.float32)
            drop[B // 2:] = 0.0  # data rank 1's agents
            check_against_one_process(REF_ARCH, mesh, gaps, accum=1, mask=drop, key="drop")
            check_checkpoint(mesh, out_dir, gaps)
        if ref_path is not None:
            with open(ref_path, "rb") as f:
                check_reference(mesh, pickle.load(f), gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
