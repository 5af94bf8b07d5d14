"""Inputs of ``test_torch_moe.py`` and its worker processes: the MoE layer's
mesh path on a gloo mesh of CPU processes. Imports neither JAX nor a test
file, so that spawned workers start fast.

``run(rank, world, out_dir)`` is the spawn entry: each rank joins a gloo
group through a file store in ``out_dir`` (no port), builds the mesh
(data=world, model=1), runs ``apply_moe`` on its rows of ``mesh_case()``'s
batch under ``activation_sharding`` and writes y, the load-balance loss
and the router's gradient of that loss to ``out_dir/rank{r}.npz``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.models import layers as L
from repro_torch.models.sharding_hooks import activation_sharding

TIED = (1, 3, 6)  # the experts whose router columns are equal in the "ties" case


def inputs(D, E, F, d_shared, B, S, router, seed):
    """float32 numpy params of a MoE layer and x (B, S, D). ``router``:
    "random"; "skewed" (experts 0-2 favoured by every token, so their
    choices overflow the capacity); "ties" (experts TIED share one router
    column, favoured by every token: their gates tie exactly)."""
    rng = np.random.default_rng(seed)

    def draw(*shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    params = {"router": draw(D, E, std=1 / np.sqrt(D)), "wg": draw(E, D, F, std=1 / np.sqrt(D)),
              "wu": draw(E, D, F, std=1 / np.sqrt(D)), "wd": draw(E, F, D, std=1 / np.sqrt(F))}
    if d_shared:
        params["shared"] = {"wg": draw(D, d_shared, std=1 / np.sqrt(D)),
                            "wu": draw(D, d_shared, std=1 / np.sqrt(D)),
                            "wd": draw(d_shared, D, std=1 / np.sqrt(d_shared))}
    x = draw(B, S, D, std=1.0)
    if router != "random":
        x += 1.0  # every token shares a direction, which the favoured columns follow
        favoured = TIED if router == "ties" else (0, 1, 2)
        if router == "ties":
            params["router"][:, list(TIED)] = params["router"][:, [TIED[0]]]
        params["router"][:, list(favoured)] += np.float32(12.0 / D)
    return params, x


def mesh_case():
    """The two-process case: reduced width, a skewed router, B = 4 (two rows
    a rank), S = 16."""
    spec = dict(d_model=64, d_expert=32, num_experts=8, top_k=2, capacity_factor=2.0)
    params, x = inputs(64, 8, 32, 0, 4, 16, "skewed", seed=11)
    return spec, params, x


def run(rank: int, world: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
        spec, params, x = mesh_case()
        rows = x.shape[0] // world
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        p["router"].requires_grad_(True)
        with activation_sharding(mesh, make_rules(mesh, "train")):
            y, aux = L.apply_moe(p, L.MoESpec(**spec),
                                 torch.from_numpy(x[rank * rows:(rank + 1) * rows]))
        grad = torch.autograd.grad(aux["lb_loss"], p["router"])[0]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), y=y.detach().numpy(),
                 lb=aux["lb_loss"].detach().numpy(), grad=grad.numpy())
    finally:
        dist.destroy_process_group()
