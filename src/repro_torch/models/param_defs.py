"""Parameter definitions: shape and init in one declaration.

Port of the reference's ``models/param_defs.py``. A model declares a nested
dict of ``ParamDef``; ``init_values`` draws it and ``ParamTree`` holds the
values as a module whose attributes (and ``[]`` items) are the sub-trees and
parameters, so layer code reads ``params["attn"]["wq"]`` as the reference
does. The reference's logical sharding axes come with the slice that shards.

The init follows the reference's fan-in rule (``init_leaf``), drawn from a
``torch.Generator``, so the numbers differ from JAX's for the same seed: the
tests carry the JAX weights across instead (``models/convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0           # multiplier on the default fan-in scale
    dtype: torch.dtype = torch.bfloat16


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
        return dataclasses.replace(defs, shape=(n,) + defs.shape)
    return {k: stack_defs(v, n) for k, v in defs.items()}


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: sub-trees are child modules,
    leaves are frozen ``nn.Parameter``s (the port serves, it does not train
    yet). ``tree[name]`` is ``getattr(tree, name)``."""

    def __init__(self, values: dict):
        super().__init__()
        for name, v in values.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _leaves(defs, prefix=()):
    """(path, def) pairs in sorted-key order, as the reference's tree flatten."""
    if isinstance(defs, ParamDef):
        yield prefix, defs
        return
    for k in sorted(defs):
        yield from _leaves(defs[k], prefix + (k,))


def init_values(defs, gen: torch.Generator, device) -> dict:
    """Draw every leaf of ``defs`` (in sorted-key order) into a nested dict
    of tensors."""
    out: dict = {}
    for path, d in _leaves(defs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = init_leaf(d, gen, device)
    return out


def unstack(values: dict, n: int) -> list:
    """Split a layer-stacked value tree into ``n`` per-layer trees (views)."""
    def part(v, i):
        return {k: part(x, i) for k, x in v.items()} if isinstance(v, dict) else v[i]

    return [part(values, i) for i in range(n)]


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for _, d in _leaves(defs)))
