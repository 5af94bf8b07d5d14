"""Carry a reference (JAX) model's parameters into the port, bit for bit.

The reference keeps each group's layers stacked on a leading ``layers`` axis
(``g0/b0/attn/wq`` is (L, d, h, hd)); the port keeps one ``ParamTree`` per
layer. ``load_jax_params`` takes the reference's params as a nested dict of
numpy arrays (``np.asarray`` of each leaf) and unstacks them into the
port's modules. bfloat16 arrays (numpy dtype ``bfloat16`` from
``ml_dtypes``, which ``torch.from_numpy`` refuses) cross as their 16-bit
patterns; every other dtype as it is, so a float32 tree loads as float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.param_defs import ParamTree


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype and bits."""
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _assign(tree: ParamTree, values: dict, layer=None, path: str = "") -> None:
    """Replace every parameter of ``tree`` by the matching leaf of ``values``
    (its slice ``layer`` of the stacked axis, if given). The two trees must
    have the same leaves."""
    names = set(tree._parameters) | set(tree._modules)
    if names != set(values):
        raise KeyError(f"{path or '/'}: port has {sorted(names)}, params have {sorted(values)}")
    for name, v in values.items():
        if isinstance(v, dict):
            _assign(tree[name], v, layer, f"{path}/{name}")
            continue
        t = to_torch(v if layer is None else np.asarray(v)[layer])
        old = tree._parameters[name]
        if tuple(t.shape) != tuple(old.shape):
            raise ValueError(f"{path}/{name}: shape {tuple(t.shape)}, port has {tuple(old.shape)}")
        tree._parameters[name] = torch.nn.Parameter(t.to(old.device), requires_grad=False)


def load_jax_params(model, tree: dict):
    """Load the reference model's params (a nested dict of numpy arrays) into
    ``model`` (a port ``TransformerLM``), in place; returns the model. Each
    parameter takes the array's dtype, on the model's device."""
    expected = {"embed", "final_norm"} | {f"g{gi}" for gi in range(len(model.cfg.groups))}
    if not model.cfg.tie_embeddings:
        expected.add("lm_head")
    if set(tree) != expected:
        raise KeyError(f"params have {sorted(tree)}, expected {sorted(expected)}")
    _assign(model.embed, tree["embed"], path="/embed")
    _assign(model.final_norm, tree["final_norm"], path="/final_norm")
    if not model.cfg.tie_embeddings:
        _assign(model.lm_head, tree["lm_head"], path="/lm_head")
    for gi, layers in enumerate(model.groups):
        for li, p in enumerate(layers):
            _assign(p, tree[f"g{gi}"], layer=li, path=f"/g{gi}[{li}]")
    return model
