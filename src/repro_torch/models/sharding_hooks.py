"""Activation-sharding hook.

Port of the reference's ``models/sharding_hooks.py``. Models call
``shard_act(x, ("batch", "act_seq", "embed"))`` at block boundaries.
Outside a mesh context it is the identity. Inside the step builder's
context (``activation_sharding``) the reference constrains the activation
to the layout that the logical -> mesh rules give; in the port each data
rank runs as its own process and already holds its batch rows, so on a
mesh whose "model" axis is 1 (the only one ported) every such layout is
the identity too. A "model" axis above 1 would split sequences or heads
across processes: tensor parallelism, which raises ``NotImplementedError``
(ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.core.sharded import DEFAULT_RULES, mesh_axis_size

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_sharding_ctx", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: Optional[dict] = None):
    merged = dict(DEFAULT_RULES, **(rules or {}))
    token = _CTX.set((mesh, merged))
    try:
        yield
    finally:
        _CTX.reset(token)


def remat_context():
    """A ``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant),
    called at the forward: its recompute runs under the forward's sharding
    context. The autograd engine runs a CUDA backward, and with it the
    recompute, on its own device thread, where the step's context (a
    ContextVar) is unset: an MoE layer would recompute on the grouped path
    after a forward on the mesh path."""
    ctx = _CTX.get()

    @contextlib.contextmanager
    def recompute():
        token = _CTX.set(ctx)
        try:
            yield
        finally:
            _CTX.reset(token)

    return contextlib.nullcontext(), recompute()


def shard_act(x: torch.Tensor, names: tuple) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None:
        return x
    if len(names) != x.dim():
        raise ValueError(f"axes {names} vs shape {tuple(x.shape)}")
    if act_mesh_axis_size("model") > 1:
        raise NotImplementedError(
            "activations split over a 'model' mesh axis (tensor parallelism) are not "
            "ported yet (ROADMAP.md queue 1)"
        )
    return x


def act_mesh_axis_size(name: str) -> int:
    """Size of a mesh axis in the active sharding context (1 if none)."""
    ctx = _CTX.get()
    if ctx is None:
        return 1
    mesh, _ = ctx
    return mesh_axis_size(mesh, name) if name in mesh.mesh_dim_names else 1
