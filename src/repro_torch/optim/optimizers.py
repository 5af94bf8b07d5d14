"""Optimizers over trees of tensors, built from scratch.

Port of the reference's ``optim/optimizers.py``, with its interface (that of
optax's GradientTransformation):

    opt = adam(lr_schedule)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)

For the IPLS / ZeRO-1 mapping (``core/sharded.py``): every state leaf has
the shape of the parameter leaf it belongs to, so a shard of the state is
a shard of the parameter, and ``update`` works leaf by leaf (no reduction
across leaves but the optional global-norm clip), so it runs unchanged on
the slice of each parameter that a data rank owns.

The arithmetic is the reference's, operation by operation, in float32: the
bias corrections ``1 - b**count``, ``lr * (m / bc1) / (sqrt(v / bc2) +
eps)``, the decoupled weight decay on the float32 parameter. Unlike the
reference, which returns new state arrays, ``momentum`` and ``adam`` update
the state's tensors IN PLACE and return the same tree: at full width the
moments are 8 bytes a parameter, and a second copy of them would double the
optimizer's peak memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]
OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any, torch.Tensor], "tuple[Any, OptState]"]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        lr_t = sched(step)
        # in float32, as the reference's 0-d float32 rate promotes a bf16 grad
        return tree_map(lambda g: lr_t * g.float(), grads), state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return tree_map(_zeros32, params)

    def update(grads, state, params, step):
        lr_t = sched(step)

        def leaf(g, m):
            g32 = g.float()
            m.mul_(beta).add_(g32)  # beta * m + g, in place
            return lr_t * (beta * m + g32) if nesterov else lr_t * m

        return tree_map(leaf, grads, state), state

    return Optimizer(init, update)


class AdamLeaf(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return tree_map(lambda p: AdamLeaf(m=_zeros32(p), v=_zeros32(p)), params)

    def update(grads, state, params, step):
        lr_t = sched(step)
        count = step.float() + 1.0
        bc1 = 1.0 - torch.pow(b1, count)
        bc2 = 1.0 - torch.pow(b2, count)

        def leaf(g, s):
            g32 = g.float()
            s.m.mul_(b1).add_((1 - b1) * g32)
            s.v.mul_(b2).add_((1 - b2) * g32.square())
            return lr_t * (s.m / bc1) / (torch.sqrt(s.v / bc2) + eps)

        # the walk follows the grads: each AdamLeaf reaches ``leaf`` whole
        return tree_map(leaf, grads, state), state

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1) -> Optimizer:
    base = adam(lr, b1, b2, eps)
    sched = _as_schedule(lr)

    def update(grads, state, params, step):
        updates, new_state = base.update(grads, state, params, step)
        lr_t = sched(step)
        updates = tree_map(lambda u, p: u + lr_t * wd * p.float(), updates, params)
        return updates, new_state

    return Optimizer(base.init, update)


def sum_in_order(values) -> torch.Tensor:
    """Python's ``sum`` of 0-d tensors, left to right, as the reference
    adds the leaves' squared norms; 0.0 for none."""
    values = list(values)
    if not values:
        return torch.zeros((), dtype=torch.float32)
    return sum(values)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum_in_order(l.float().square().sum() for l in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-12))`` (a true division)."""
    return torch.clamp(torch.full_like(norm, max_norm) / norm.clamp_min(1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda l: l * scale.to(l.dtype), tree), norm


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping."""

    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params, step)

    return Optimizer(opt.init, update)
