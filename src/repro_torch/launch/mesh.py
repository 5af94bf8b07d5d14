"""Device meshes for the datacenter mapping, on
``torch.distributed.device_mesh.DeviceMesh``.

Port of the reference's ``launch/mesh.py``, with its axis names: single-pod
(16, 16) = ("data", "model"), 256 devices; multi-pod (2, 16, 16) =
("pod", "data", "model"), 512 devices, the "pod" axis being the IPLS
replica axis (rho = number of pods). One process drives one device, as
``torch.distributed`` has it: a mesh of N devices needs N processes and a
process group that the launcher started (its address, world size and rank
given). ``make_smoke_mesh`` needs none: it starts a one-process group
itself when there is none, so a single process runs the same code paths.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def _mesh(device, shape, axes) -> DeviceMesh:
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_mesh(shape, axes, device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over the process group's
    ranks (row-major: the last axis varies fastest), on CUDA unless
    ``device="cpu"`` (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start one with torch.distributed.init_process_group "
            "(address, world size and rank) before building a mesh"
        )
    return _mesh(device, tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(device="cuda") -> DeviceMesh:
    """A (1, 1) mesh with the production axis names ("data", "model"): the
    smoke runs take the same sharding code paths on one device. Without a
    process group it starts a one-process one (NCCL on CUDA, gloo on the
    CPU) over an in-process store; an existing group must have that backend
    for the device (``ValueError`` otherwise: a CUDA mesh over gloo would
    not run the collectives the card path assumes). The caller destroys the
    group (``torch.distributed.destroy_process_group``) when done."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif backend not in str(dist.get_backend()):
        raise ValueError(
            f"a {dist.get_backend()!r} process group exists; a {dev.type} mesh needs "
            f"{backend!r}: destroy the group first"
        )
    return _mesh(dev, (1, 1), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel (IPLS agent) axes of this mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def make_rules(mesh, shape_kind: str, long_context: bool = False) -> dict:
    """Logical -> mesh rules for a mesh and an execution shape.

    train:   batch over all data-parallel axes; sequence-parallel
             activations over model.
    prefill: as train (forward only).
    decode:  batch over the data-parallel axes; the KV sequence
             context-parallel over model, and over (data, model) for the
             batch-1 long-context shape.
    """
    dp = dp_axes(mesh)
    rules: dict = {"batch": dp if len(dp) > 1 else dp[0]}
    if shape_kind == "decode":
        rules["kv_seq"] = ("data", "model") if long_context else "model"
        rules["act_seq"] = None  # single-token activations
    return rules
