"""Carry a reference (JAX) model's parameters into the port, bit for bit.

The reference keeps each group's layers stacked on a leading ``layers`` axis
(``g0/b0/attn/wq`` is (L, d, h, hd)); the port keeps one ``ParamTree`` per
layer. ``load_jax_params`` takes the reference's params as a nested dict of
numpy arrays (``np.asarray`` of each leaf) and unstacks them into the
port's modules. bfloat16 arrays (numpy dtype ``bfloat16`` from
``ml_dtypes``, which ``torch.from_numpy`` refuses) cross as their 16-bit
patterns; every other dtype as it is, so a float32 tree loads as float32.

On a tensor-parallel mesh (a model built with a "model" axis above 1)
``load_jax_params`` keeps each leaf's shard for this rank (its spec's
slice, ``core/sharded.py`` ``shard``), and ``gather_params`` gathers the
shards back into whole leaves, bit for bit.

``load_jax_cache`` carries a reference serving cache (a prefill's) across in
the same way, so that the port's decode step can start from it.
``load_jax_state`` carries a whole reference ``IplsTrainState`` across in
the same way (params, the optimizer state unstacked per layer as the
params are, step and eps), and ``to_reference_layout`` stacks a port state
back into the reference's layout, so that the two packages' states compare
leaf for leaf by name (``repro_torch.tree.named_leaves``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sharded import IplsTrainState, gather_tree, shard
from repro_torch.models.param_defs import ParamTree
from repro_torch.models.whisper import WhisperModel
from repro_torch.optim.optimizers import AdamLeaf
from repro_torch.tree import tree_map


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype and bits."""
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _assign(tree: ParamTree, values: dict, layer=None, path: str = "", specs=None,
            mesh=None) -> None:
    """Replace every parameter of ``tree`` by the matching leaf of ``values``
    (its slice ``layer`` of the stacked axis, if given; with ``specs``, the
    tree's specs on ``mesh``, this rank's "model" shard of it). The two
    trees must have the same leaves."""
    names = set(tree._parameters) | set(tree._modules)
    if names != set(values):
        raise KeyError(f"{path or '/'}: port has {sorted(names)}, params have {sorted(values)}")
    for name, v in values.items():
        if isinstance(v, dict):
            _assign(tree[name], v, layer, f"{path}/{name}",
                    None if specs is None else specs[name], mesh)
            continue
        t = to_torch(v if layer is None else np.asarray(v)[layer])
        if specs is not None:
            t = shard(t, specs[name], mesh, ("model",)).contiguous()
        old = tree._parameters[name]
        if tuple(t.shape) != tuple(old.shape):
            raise ValueError(f"{path}/{name}: shape {tuple(t.shape)}, port has {tuple(old.shape)}")
        tree._parameters[name] = torch.nn.Parameter(t.to(old.device), requires_grad=False)


def _load_whisper(model, tree: dict):
    """A reference ``WhisperModel``'s params into a port one: ``enc`` and
    ``dec`` unstacked per layer, ``embed``, ``pos_dec``, ``enc_ln`` and
    ``dec_ln`` as they are (on a tensor-parallel mesh, this rank's shards)."""
    expected = {"embed", "pos_dec", "enc", "dec", "enc_ln", "dec_ln"}
    if set(tree) != expected:
        raise KeyError(f"params have {sorted(tree)}, expected {sorted(expected)}")
    specs, mesh = model.param_specs, model.mesh

    def sub(key, li=None):
        if specs is None:
            return {}
        return {"specs": specs[key] if li is None else specs[key][li], "mesh": mesh}

    for key in ("embed", "enc_ln", "dec_ln"):
        _assign(getattr(model, key), tree[key], path=f"/{key}", **sub(key))
    pos = to_torch(tree["pos_dec"])
    if specs is not None:
        pos = shard(pos, specs["pos_dec"], mesh, ("model",)).contiguous()
    if tuple(pos.shape) != tuple(model.pos_dec.shape):
        raise ValueError(f"/pos_dec: shape {tuple(pos.shape)}, port has "
                         f"{tuple(model.pos_dec.shape)}")
    model.pos_dec = torch.nn.Parameter(pos.to(model.pos_dec.device), requires_grad=False)
    for key in ("enc", "dec"):
        for li, p in enumerate(getattr(model, key)):
            _assign(p, tree[key], layer=li, path=f"/{key}[{li}]", **sub(key, li))
    return model


def load_jax_params(model, tree: dict):
    """Load the reference model's params (a nested dict of numpy arrays) into
    ``model`` (a port ``TransformerLM`` or ``WhisperModel``), in place;
    returns the model. Each parameter takes the array's dtype, on the
    model's device. A group's shared blocks (``g{gi}_shared``, unstacked)
    load into the model's one copy of them. A model built on a
    tensor-parallel mesh keeps this rank's shard of each leaf."""
    if isinstance(model, WhisperModel):
        return _load_whisper(model, tree)
    specs = getattr(model, "param_specs", None)
    mesh = getattr(model, "mesh", None)

    def sub(key, li=None):
        if specs is None:
            return {}
        return {"specs": specs[key] if li is None else specs[key][li], "mesh": mesh}

    groups = model.cfg.groups
    shared = [f"g{gi}_shared" for gi, g in enumerate(groups) if g.shared]
    expected = {"embed", "final_norm", *shared} | {f"g{gi}" for gi in range(len(groups))}
    if not model.cfg.tie_embeddings:
        expected.add("lm_head")
    if set(tree) != expected:
        raise KeyError(f"params have {sorted(tree)}, expected {sorted(expected)}")
    _assign(model.embed, tree["embed"], path="/embed", **sub("embed"))
    _assign(model.final_norm, tree["final_norm"], path="/final_norm", **sub("final_norm"))
    if not model.cfg.tie_embeddings:
        _assign(model.lm_head, tree["lm_head"], path="/lm_head", **sub("lm_head"))
    for gi, layers in enumerate(model.groups):
        for li, p in enumerate(layers):
            _assign(p, tree[f"g{gi}"], layer=li, path=f"/g{gi}[{li}]", **sub(f"g{gi}", li))
    for key in shared:
        _assign(getattr(model, key), tree[key], path=f"/{key}", **sub(key))
    return model


def gather_params(model) -> dict:
    """The model's parameters as whole leaves (``params()``'s layout): on a
    tensor-parallel mesh gathered over "model" (a collective: every rank
    of the axis calls it), else ``params()`` itself."""
    if getattr(model, "mesh", None) is None:
        return model.params()
    return gather_tree(model.params(), model.param_specs, model.mesh)


def _keys(tree):
    return {k: _keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def load_jax_cache(model, cache: dict) -> dict:
    """The reference's serving cache (a nested dict of numpy arrays, each
    group's layers, and whisper's ``dec`` layers, stacked on a leading axis)
    in the port's layout on the model's device, bit for bit: a list of
    per-layer dicts in each ``g{gi}`` (``b{bi}`` / ``s{bi}``) or in ``dec``,
    and for whisper ``enc_last`` (S_enc - 1), which the reference does not
    keep. Raises ``KeyError`` where the entries differ from the model's
    ``cache_defs``."""
    dev = model.device
    if isinstance(model, WhisperModel):
        want = {"dec": model.cache_defs(1, 1, 1)["dec"][0]}
        stacked = {"dec": (cache.get("dec"), model.cfg.dec_layers)} if "dec" in cache else {}
    else:
        want = {k: v[0] for k, v in model.cache_defs(1, 1).items()}
        stacked = {k: (v, model.cfg.groups[int(k[1:])].repeat) for k, v in cache.items()}
    got = {k: v for k, (v, _) in stacked.items()}
    if _keys(got) != _keys(want):
        raise KeyError(f"cache has {_keys(got)}, the model's is {_keys(want)}")
    out = {k: [tree_map(lambda a, i=i: to_torch(np.asarray(a)[i]).to(dev), tree) for i in range(n)]
           for k, (tree, n) in stacked.items()}
    if isinstance(model, WhisperModel):
        out["enc_last"] = model._enc_last(out["dec"][0]["ek"].shape[1])
    return out


def _opt_leaf(x, layer, device):
    """A reference optimizer-state leaf (an array, or an AdamLeaf of two)
    as the port's, its slice ``layer`` of the stacked axis if given."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        if tuple(x._fields) != AdamLeaf._fields:
            raise TypeError(f"unknown optimizer state leaf {type(x).__name__}{x._fields}")
        return AdamLeaf(*(_opt_leaf(a, layer, device) for a in x))
    return to_torch(np.asarray(x) if layer is None else np.asarray(x)[layer]).to(device)


def _opt_tree(tree, layer, device):
    if isinstance(tree, dict):
        return {k: _opt_tree(v, layer, device) for k, v in tree.items()}
    return _opt_leaf(tree, layer, device)


def _stacked(model) -> dict:
    """The keys of a model's params tree that the reference stacks on a
    leading ``layers`` axis, with their layer counts: each group ``g{gi}``
    (a group's shared blocks ``g{gi}_shared`` are not stacked), whisper's
    ``enc`` and ``dec``."""
    if isinstance(model, WhisperModel):
        return {"enc": model.cfg.enc_layers, "dec": model.cfg.dec_layers}
    return {f"g{gi}": g.repeat for gi, g in enumerate(model.cfg.groups)}


def load_jax_state(model, state):
    """A reference ``IplsTrainState`` (fields step, params, opt_state, eps;
    leaves numpy arrays) as the port's: its params loaded into ``model``
    (``load_jax_params``) and the state's params the model's own tensors
    (``model.params()``), the optimizer state (empty for SGD, a float32
    array per parameter for momentum, an AdamLeaf per parameter for
    Adam/AdamW) unstacked per layer as the params are, step and eps as 0-d
    tensors; all on the model's device."""
    load_jax_params(model, state.params)
    dev = model.device
    opt = state.opt_state
    if not (isinstance(opt, tuple) and len(opt) == 0):
        stacked = _stacked(model)
        opt = {k: ([_opt_tree(v, li, dev) for li in range(stacked[k])] if k in stacked
                   else _opt_tree(v, None, dev)) for k, v in opt.items()}
    return IplsTrainState(step=to_torch(np.asarray(state.step)).to(dev),
                          params=model.params(), opt_state=opt,
                          eps=to_torch(np.asarray(state.eps)).to(dev))


def _stack(x):
    """A per-layer list of trees (tensors or AdamLeafs) stacked on a
    leading axis, on the CPU."""
    first = x[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in x]) for k in first}
    if isinstance(first, AdamLeaf):
        return AdamLeaf(*(_stack([t[i] for t in x]) for i in range(len(first))))
    return torch.stack([t.detach().cpu() for t in x])


def _host(x):
    if isinstance(x, dict):
        return {k: (_stack(v) if isinstance(v, list) else _host(v)) for k, v in x.items()}
    if isinstance(x, AdamLeaf):
        return AdamLeaf(*(_host(a) for a in x))
    return x.detach().cpu().clone()


def to_reference_layout(state: IplsTrainState) -> IplsTrainState:
    """A port state in the reference's layout, as CPU tensors: every
    per-layer list (a group's, whisper's ``enc`` and ``dec``) stacked on a
    leading ``layers`` axis (params and optimizer state alike). Its
    ``named_leaves`` are the names ``jax.tree_util.keystr`` gives the
    reference state's leaves."""
    opt = state.opt_state
    return IplsTrainState(step=_host(state.step), params=_host(state.params),
                          opt_state=opt if opt == () else _host(opt), eps=_host(state.eps))
