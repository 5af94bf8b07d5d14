"""Parameter definitions: shape, logical sharding axes and init in one
declaration.

Port of the reference's ``models/param_defs.py``. A model declares a nested
dict of ``ParamDef``; ``init_values`` draws it and ``ParamTree`` holds the
values as a module whose attributes (and ``[]`` items) are the sub-trees and
parameters, so layer code reads ``params["attn"]["wq"]`` as the reference
does. ``axes_tree`` gives the matching tree of logical-axis tuples, which
``core/sharded.py`` maps onto a mesh (the IPLS partition plane).

The init follows the reference's fan-in rule (``init_leaf``), drawn from a
``torch.Generator``, so the numbers differ from JAX's for the same seed: the
tests carry the JAX weights across instead (``models/convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # one logical axis name (or None) per dim
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0           # multiplier on the default fan-in scale
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def init_leaf(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    """One leaf, drawn on ``device`` from ``gen`` (a generator of that device)."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        std = d.scale
    else:
        # the reference's fan-in rule, applied to the declared (for a stacked
        # period: layer-stacked) shape, so the draws have its scales
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale / np.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(d.dtype)


def stack_defs(defs, n: int):
    """Stack a period's defs n times along a new leading ``layers`` axis (the
    reference's scan layout); ``init_values`` draws a stacked leaf at once
    and ``unstack`` splits it into per-layer trees."""
    if isinstance(defs, ParamDef):
        return dataclasses.replace(defs, shape=(n,) + defs.shape, axes=("layers",) + defs.axes)
    return {k: stack_defs(v, n) for k, v in defs.items()}


def axes_tree(defs):
    """The tree of logical-axis tuples matching ``defs`` (dicts and, in the
    port's per-layer layouts, lists)."""
    if isinstance(defs, ParamDef):
        return defs.axes
    if isinstance(defs, list):
        return [axes_tree(v) for v in defs]
    return {k: axes_tree(v) for k, v in defs.items()}


def unstack_axes(defs, n: int) -> list:
    """``n`` per-layer copies of a stacked period's axes, the leading
    ``layers`` axis removed (the port keeps one tree per layer)."""
    def drop(v):
        if isinstance(v, ParamDef):
            if v.axes[:1] != ("layers",):
                raise ValueError(f"not a layer-stacked def: axes {v.axes}")
            return v.axes[1:]
        return {k: drop(x) for k, x in v.items()}

    return [drop(defs) for _ in range(n)]


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: sub-trees are child modules,
    leaves frozen ``nn.Parameter``s (the train step takes its gradients
    through detached aliases of them, ``core/sharded.py``).
    ``tree[name]`` is ``getattr(tree, name)``; ``as_dict()`` is the nested
    dict of the parameters themselves (no copies)."""

    def __init__(self, values: dict):
        super().__init__()
        for name, v in values.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def as_dict(self) -> dict:
        out = {k: m.as_dict() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


def _leaves(defs, prefix=()):
    """(path, def) pairs in sorted-key order, as the reference's tree flatten."""
    if isinstance(defs, ParamDef):
        yield prefix, defs
        return
    for k in sorted(defs):
        yield from _leaves(defs[k], prefix + (k,))


def init_values(defs, gen: torch.Generator, device, cut=None) -> dict:
    """Draw every leaf of ``defs`` (in sorted-key order) into a nested dict
    of tensors. With ``cut(path, tensor)`` (a rank's shard of a leaf, on a
    tensor-parallel mesh) each leaf keeps only what ``cut`` returns, in
    storage of its own: the generator's stream has no skip, so a leaf is
    drawn whole (one leaf at a time) and its shard has the bits of the same
    slice of the one-process draw."""
    out: dict = {}
    for path, d in _leaves(defs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        value = init_leaf(d, gen, device)
        node[path[-1]] = value if cut is None else cut(path, value).clone()
        del value
    return out


def unstack(values: dict, n: int) -> list:
    """Split a layer-stacked value tree into ``n`` per-layer trees whose
    leaves own their storage (copies, not views: a view would keep its
    whole stacked draw alive, so that converting a model's layers one by
    one, as ``model.float()`` does, held both dtypes at once). The stacked
    leaves are taken out of ``values`` as they are split, so each frees
    once its copies exist."""
    out: list = [{} for _ in range(n)]

    def split(src: dict, dsts: list) -> None:
        for k in list(src):
            v = src.pop(k)
            if isinstance(v, dict):
                split(v, [d.setdefault(k, {}) for d in dsts])
            else:
                for i, d in enumerate(dsts):
                    d[k] = v[i].clone()
            del v

    split(values, out)
    return out


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for _, d in _leaves(defs)))
