"""Worker processes for ``test_torch_sharded_dist.py``: the IPLS train step
on a gloo mesh of several CPU processes against the same step on one
process. Imports neither JAX nor a test file, so that spawned workers
start fast.

``run(world, out_dir)`` is the spawn entry (``run_mrope`` the same for
qwen2-vl's M-RoPE case alone): each rank joins a gloo group
through a file store in ``out_dir`` (no port), builds the mesh (data=2, model=1)
for a world of 2 or (pod=2, data=2, model=1) for 4, runs every case, checks
it, and writes its largest gaps to ``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.optim import adam, adamw, sgd
from repro_torch.serve_lm import image_positions3
from repro_torch.tree import named_leaves, tree_leaves

# float32 sums over ranks in another order than one process's batch sums
TOL = 1e-5

# leaves whose ZeRO-1 dim is 0, 1, or none (replicated, updated whole)
AXES = {"a": ("embed", "ffn"), "b": (None, None), "c": (None,)}
SHAPES = {"a": (4, 6), "b": (3, 4), "c": (3,)}


def tiny_loss(params, batch):
    h = torch.tanh(batch["x"] @ params["a"])            # (B, 6)
    y = h[:, :4] @ params["b"].t() + params["c"]       # (B, 3)
    return (y - batch["y"]).square().mean(dim=-1), {}


def _tiny_inputs(B):
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SHAPES.items()}
    batch = {"x": torch.from_numpy(rng.standard_normal((B, 4)).astype(np.float32)),
             "y": torch.from_numpy(rng.standard_normal((B, 3)).astype(np.float32))}
    return params, batch


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _metric_gaps(name, got, want, gaps):
    """Metrics relative to max(1, |value|): the loss and grad norm are
    sums over the whole model."""
    for k in got:
        gaps[name] = max(gaps[name], _gap(got[k], want[k]) / max(1.0, abs(float(want[k]))))
    assert gaps[name] <= TOL, (name, gaps[name])


def _dp(mesh):
    names = mesh.mesh_dim_names
    p = mesh.get_local_rank("pod") if "pod" in names else 0
    P = psh.mesh_axis_size(mesh, "pod") if "pod" in names else 1
    D = psh.mesh_axis_size(mesh, "data")
    return p * D + mesh.get_local_rank("data"), P * D


def _masks(B, dp_size):
    """All participating, and the agents of data-parallel rank 1 dropped."""
    drop = np.ones(B, np.float32)
    rows = B // dp_size
    drop[rows:2 * rows] = 0.0
    return {"all": np.ones(B, np.float32), "drop_rank1": drop}


def _check_state(name, mesh_state, one_state, specs, rank_d, D, gaps):
    """Params in full, the optimizer state's owned slices, step and eps."""
    gaps[name] = max(_gap(a, b) for a, b in zip(tree_leaves(mesh_state.params),
                                                 tree_leaves(one_state.params)))
    dims = [psh.owned_dim(s) for s in psh.tree_leaves_of_specs(specs, mesh_state.params)]
    for (n, got), (_, full) in zip(named_leaves(mesh_state.opt_state),
                                   named_leaves(one_state.opt_state)):
        k = dims[_leaf_index(n, mesh_state.params)]
        want = full if k is None else full.narrow(k, rank_d * (full.shape[k] // D),
                                                   full.shape[k] // D)
        assert got.shape == want.shape, (name, n, got.shape, want.shape)
        gaps[name] = max(gaps[name], _gap(got, want))
    assert int(mesh_state.step) == int(one_state.step)
    gaps[name] = max(gaps[name], _gap(mesh_state.eps, one_state.eps))
    assert gaps[name] <= TOL, (name, gaps[name])


def _leaf_index(opt_name: str, params) -> int:
    """The index (in ``tree_leaves(params)`` order) of the parameter that an
    optimizer-state leaf belongs to: its name up to a trailing ``.m``/``.v``."""
    base = opt_name.rsplit(".", 1)[0] if opt_name.endswith((".m", ".v")) else opt_name
    return [n for n, _ in named_leaves(params)].index(base)


def _tiny_cases(mesh, gaps):
    rank_d, D = mesh.get_local_rank("data"), psh.mesh_axis_size(mesh, "data")
    dp_rank, dp_size = _dp(mesh)
    B = 4 * dp_size
    rules = dict(psh.DEFAULT_RULES, ffn="model")
    specs = psh.tree_shardings(AXES, SHAPES, mesh, rules, "data")
    assert [psh.owned_dim(specs[k]) for k in ("a", "b", "c")] == [0, 1, None], specs
    for mask_name, mask in _masks(B, dp_size).items():
        for cfg in (psh.IplsStepConfig(grad_clip=0.5, accum_steps=2),
                    psh.IplsStepConfig(grad_clip=None, alpha=0.3)):
            params, batch = _tiny_inputs(B)
            batch["participation"] = torch.from_numpy(mask)
            rows = slice(dp_rank * (B // dp_size), (dp_rank + 1) * (B // dp_size))
            local = {k: v[rows] for k, v in batch.items()}
            states = []
            for m, shardings, b in ((mesh, specs, local), (None, None, batch)):
                opt = adam(1e-2)
                step = psh.make_train_step(tiny_loss, opt, cfg, num_agents=dp_size,
                                           update_shardings=shardings, mesh=m)
                st = psh.init_state({k: v.clone() for k, v in params.items()}, opt, shardings, m)
                for _ in range(3):
                    st, metrics = step(st, b)
                states.append((st, metrics))
            (ms, mm), (os_, om) = states
            name = f"tiny/{mask_name}/accum{cfg.accum_steps}"
            _check_state(name, ms, os_, specs, rank_d, D, gaps)
            _metric_gaps(name, mm, om, gaps)


def _lm_cases(mesh, gaps):
    """internlm2-reduced in float32, one step through build_train_step on
    the mesh, against make_train_step on one process over the global
    batch."""
    rank_d, D = mesh.get_local_rank("data"), psh.mesh_axis_size(mesh, "data")
    _, dp_size = _dp(mesh)
    cfg = get_config("internlm2-1.8b", reduced=True)
    B, S = 2 * dp_size, 16
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32))
    for mask_name, mask in _masks(B, dp_size).items():
        for make_opt, step_cfg in ((lambda: sgd(0.1), psh.IplsStepConfig(grad_clip=1.0)),
                                   (lambda: adamw(1e-3), psh.IplsStepConfig(accum_steps=2))):
            batch = {"tokens": tokens, "participation": torch.from_numpy(mask)}
            model = build_model(cfg, device="cpu", seed=0).float()
            built = build_train_step(model, mesh, ShapeSpec("t", S, B, "train"),
                                     optimizer=make_opt(), step_cfg=step_cfg)
            st = built.init_state(model.params())
            one = build_model(cfg, device="cpu", seed=0).float()
            opt1 = make_opt()
            step1 = psh.make_train_step(one.loss, opt1, step_cfg, num_agents=dp_size)
            st1 = psh.init_state(one.params(), opt1)
            # one step: a second one's gradient would be taken at parameters
            # that differ by the first's rounding, which the reduced model's
            # near one-hot attention (random init) amplifies
            st, metrics = built.fn(st, batch)
            st1, metrics1 = step1(st1, batch)
            name = f"lm/{mask_name}/accum{step_cfg.accum_steps}/clip{step_cfg.grad_clip}"
            _check_state(name, st, st1, built.update_shardings, rank_d, D, gaps)
            _metric_gaps(name, metrics, metrics1, gaps)
            if mask_name == "drop_rank1":
                assert float(metrics["participation"]) == 1 - 1 / dp_size


def _mrope_case(mesh, gaps):
    """qwen2-vl-reduced in float32 (M-RoPE: positions3 (3, B, S) with an
    image, which ``shard_batch`` splits over the data ranks on its dim 1),
    one AdamW step through build_train_step on the mesh, against
    make_train_step on one process over the global batch."""
    rank_d, D = mesh.get_local_rank("data"), psh.mesh_axis_size(mesh, "data")
    _, dp_size = _dp(mesh)
    cfg = get_config("qwen2-vl-72b", reduced=True)
    B, S = 2 * dp_size, 16
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32))
    p3 = image_positions3(B, S, 3, (2, 3))
    p3[:, B // 2:] = image_positions3(B // 2, S, 6, (3, 2))  # the ranks' rows differ
    batch = {"tokens": tokens, "positions3": p3, "participation": torch.ones(B)}
    model = build_model(cfg, device="cpu", seed=2).float()
    built = build_train_step(model, mesh, ShapeSpec("t", S, B, "train"), optimizer=adamw(1e-3))
    st = built.init_state(model.params())
    one = build_model(cfg, device="cpu", seed=2).float()
    opt1 = adamw(1e-3)
    step1 = psh.make_train_step(one.loss, opt1, psh.IplsStepConfig(), num_agents=dp_size)
    st1 = psh.init_state(one.params(), opt1)
    st, metrics = built.fn(st, batch)
    st1, metrics1 = step1(st1, batch)
    _check_state("mrope", st, st1, built.update_shardings, rank_d, D, gaps)
    _metric_gaps("mrope", metrics, metrics1, gaps)


def _run(rank: int, world: int, out_dir: str, cases) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
                            rank=rank, world_size=world)
    try:
        if world == 2:
            mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
        else:
            mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
        gaps: dict = {}
        for case in cases:
            case(mesh, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()


def run(rank: int, world: int, out_dir: str) -> None:
    _run(rank, world, out_dir, (_tiny_cases, _lm_cases))


def run_mrope(rank: int, world: int, out_dir: str) -> None:
    _run(rank, world, out_dir, (_mrope_case,))
