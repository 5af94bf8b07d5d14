"""Activation sharding: the layout changes of the "model" mesh axis.

Port of the reference's ``models/sharding_hooks.py``. Models call
``shard_act(x, ("batch", "act_seq", "embed"))`` at block boundaries.
Outside a mesh context it is the identity. Inside the step builder's
context (``activation_sharding``) the reference constrains the activation
to the layout that the logical -> mesh rules give and lets GSPMD insert the
collectives. In the port each rank runs as its own process and already
holds its batch rows (the data axes), so only the "model" axis changes a
layout, and the change is an explicit collective on its process group.
On a "model" axis above 1 the residual stream between blocks is
sequence-parallel (``act_seq``: rank r holds rows [r S/M, (r+1) S/M)),
and the models call the layout changes as ``torch.autograd.Function``s:

* ``gather_seq``: a sequence-split tensor whole on every rank (all-gather
  forward; reduce-scatter backward, the ranks' gradients being partial);
* ``scatter_seq``: the rank's rows of the sum over ranks of a partial
  whole tensor (reduce-scatter forward, all-gather backward): the
  row-parallel output projections and the vocab-parallel lookup;
* ``sum_model``: the sum over ranks (all-reduce forward, the identity
  backward: every rank goes on with the same value, so each takes the
  gradient of its own part), for decode's row-parallel outputs and the
  vocab-parallel cross entropy;
* ``once_over_model``: the identity forward, whose gradient only the
  axis's rank 0 keeps: a term every rank computes alike (the MoE
  load-balance loss) counts once in the gradients the ranks sum;
* ``sum_parts``: the sum over ranks of parts of a value that each rank
  then uses for its own part of the output (a norm's squares over a width
  split over the axis): all-reduce forward and backward, each rank's
  gradient of the sum being partial;
* ``cols_to_rows``: whole rows of the rank's columns (B, S, D/M) to the
  rank's rows of every column (B, S/M, D), one all-to-all (backward: the
  reverse all-to-all): RWKV6's time mix, whose output projection
  contracts nothing over its split dim;
* ``to_parts``: the identity forward on a value that is the same on every
  rank (a sequence that does not split over the axis, whole everywhere)
  and that each rank uses for its own part (its heads, its ffn columns,
  its rows' queries), all-reduce backward (Megatron's f);
* ``gather_alike``: a sequence-split tensor whole on every rank, which
  every rank then uses alike (all-gather forward; backward the rank's
  piece of a gradient that is the same on every rank).

Decode's context-parallel group (``context_parallel``) is the axes the
step's rules give ``kv_seq``: "model", or ("data", "model") under the
long-context rules, one pod's data x model ranks flattened row-major.

FSDP (``IplsStepConfig(fsdp=True)``): the train step stores each split
parameter leaf as this rank's "data" shard and runs the loss under
``stored_params``; the models call ``gather_stored`` on each layer's tree
inside the layer's checkpoint (and on the embedding, norms and heads where
they use them), which all-gathers such a leaf over "data" (forward) and
reduce-scatters its gradient as a sum (backward): the reference's
per-layer gather in its scan.

``shard_act`` itself stays the identity (it checks the names' count): the
models call these changes where their layouts change
(``models/transformer.py``, ``models/layers.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.core.sharded import (
    DEFAULT_RULES,
    all_gather_dim,
    call_collective,
    mesh_axis_size,
    model_size,
)
from repro_torch.tree import tree_map

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_sharding_ctx", default=None)
# the train step's stored shards under fsdp: ({id(leaf): its dim over "data"}, the axis)
_STORED: contextvars.ContextVar = contextvars.ContextVar("fsdp_stored", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: Optional[dict] = None):
    merged = dict(DEFAULT_RULES, **(rules or {}))
    token = _CTX.set((mesh, merged))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def stored_params(dims: dict, axis: "TP"):
    """The train step's fsdp storage for the block: ``dims`` maps the
    ``id`` of each stored leaf (the tensors the loss receives) to its dim
    over "data"; ``axis`` is the "data" axis (group, size, rank)."""
    token = _STORED.set((dims, axis))
    try:
        yield
    finally:
        _STORED.reset(token)


def remat_context():
    """A ``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant),
    called at the forward: its recompute runs under the forward's sharding
    context and fsdp storage. The autograd engine runs a CUDA backward, and
    with it the recompute, on its own device thread, where the step's
    contexts (ContextVars) are unset: an MoE layer would recompute on the
    grouped path after a forward on the mesh path, and a layer would not
    gather its stored weights."""
    ctx, stored = _CTX.get(), _STORED.get()

    @contextlib.contextmanager
    def recompute():
        token, token_s = _CTX.set(ctx), _STORED.set(stored)
        try:
            yield
        finally:
            _STORED.reset(token_s)
            _CTX.reset(token)

    return contextlib.nullcontext(), recompute()


class TP(NamedTuple):
    """The "model" axis of the active context: its process group, size and
    this process's rank along it."""
    group: object
    size: int
    rank: int


def tensor_parallel() -> Optional[TP]:
    """The active context's "model" axis when it is above 1, else None."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, _ = ctx
    M = model_size(mesh)
    if M == 1:
        return None
    return TP(mesh.get_group("model"), M, mesh.get_local_rank("model"))


def context_parallel() -> Optional[TP]:
    """The active context's context-parallel group of a decode step's
    caches, when it is above 1, else None: the mesh axes that its rules
    give ``kv_seq``. That is "model" (the same group as
    ``tensor_parallel``) or, under the long-context rules, ("data",
    "model"): one pod's data x model ranks flattened, rank (d, m) at
    d M + m, which holds slots [(d M + m) T, (d M + m + 1) T) of the
    cache."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, rules = ctx
    axes = rules.get("kv_seq")
    if axes is None:
        return None
    axes = axes if isinstance(axes, tuple) else (axes,)
    size = mesh_axis_size(mesh, axes)
    if size == 1:
        return None
    if len(axes) == 1:
        return TP(mesh.get_group(axes[0]), size, mesh.get_local_rank(axes[0]))
    # the mesh caches its flattened group; a fake world's mesh builds it
    # from real tensors
    with unset_fake_temporarily():
        flat = mesh[axes]._flatten()
    return TP(flat.get_group(), size, flat.get_local_rank())


def _gather(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    return all_gather_dim(x, dim, tp.group, tp.size)


def _reduce_scatter(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    moved = x.movedim(dim, 0).contiguous()
    if moved.shape[0] % tp.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {tp.size} ranks")
    out = moved.new_empty((moved.shape[0] // tp.size,) + tuple(moved.shape[1:]))
    call_collective(dist.reduce_scatter_tensor, out, moved, group=tp.group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, tp: TP, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    call_collective(dist.all_reduce, x, op=op, group=tp.group)
    return x


def _all_to_all(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """x (M, ...): piece q to rank q; returns (M, ...), piece q from rank q."""
    x = x.contiguous()
    out = torch.empty_like(x)
    call_collective(dist.all_to_all_single, out, x, group=tp.group)
    return out


def _cols_to_rows(x: torch.Tensor, tp: TP) -> torch.Tensor:
    B, S, Dl = x.shape
    if S % tp.size:
        raise ValueError(f"a sequence of {S} does not split over {tp.size} ranks")
    Sl = S // tp.size
    got = _all_to_all(x.reshape(B, tp.size, Sl, Dl).movedim(1, 0), tp)  # rank q's columns
    return got.permute(1, 2, 0, 3).reshape(B, Sl, tp.size * Dl)


def _rows_to_cols(x: torch.Tensor, tp: TP) -> torch.Tensor:
    B, Sl, D = x.shape
    Dl = D // tp.size
    got = _all_to_all(x.reshape(B, Sl, tp.size, Dl).permute(2, 0, 1, 3), tp)  # rank q's rows
    return got.movedim(0, 1).reshape(B, tp.size * Sl, Dl)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _gather(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.tp), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _reduce_scatter(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.tp), None, None


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


class _ColsToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _cols_to_rows(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _rows_to_cols(grad, ctx.tp), None


class _ToParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, x.shape[dim]
        return _gather(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        piece = grad.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n).contiguous()
        return piece, None, None


class _OnceOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.keep = tp.rank == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None


def gather_seq(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    """The ranks' pieces of ``x`` along ``dim`` (the sequence) concatenated
    in rank order, on every rank."""
    return _GatherSeq.apply(x, dim, tp)


def scatter_seq(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum over ranks of ``x``."""
    return _ScatterSeq.apply(x, dim, tp)


def sum_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum over the ranks of ``x``, the same on every rank."""
    return _SumModel.apply(x, tp)


def sum_parts(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum over the ranks of ``x``, where each rank goes on to use the
    sum for its own part of a partial output (``sum_model`` is for a sum
    that the ranks then use alike): its gradient is summed over the ranks
    too."""
    return _SumParts.apply(x, tp)


def cols_to_rows(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """x (B, S, D/M), whole rows of this rank's columns (the ranks' in
    rank order make D), as (B, S/M, D): this rank's rows of every column."""
    return _ColsToRows.apply(x, tp)


def to_parts(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """``x``, the same on every rank, entering a region where each rank
    computes its own part of a result from it: its gradient, partial on
    each rank, summed over the axis."""
    return _ToParts.apply(x, tp)


def gather_alike(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    """``gather_seq`` for a whole tensor that every rank then uses alike
    (each rank's gradient of it the same): backward, the rank's piece of
    that gradient, not a sum over the ranks."""
    return _GatherAlike.apply(x, dim, tp)


def once_over_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """``x``, whose gradient counts on the axis's rank 0 only: for a value
    that every rank computes alike from whole inputs, so that the sum of
    the ranks' gradients holds its gradient once, not ``tp.size`` times."""
    return _OnceOverModel.apply(x, tp)


def cache_layout(T: int, kv_heads: Optional[int], M: int) -> str:
    """Where a cache leaf of whole length T lies over a model axis of M, as
    the reference's ``spec_for_leaf`` gives its ("batch", "kv_seq",
    "kv_heads", None) axes (("batch", "kv_seq", None) for MLA's latent and
    rope key: ``kv_heads`` None): "slots" (each rank T / M of them) where T
    divides M, else "heads" (each rank its kv heads) where they do, else
    "whole" on every rank."""
    if T % M == 0:
        return "slots"
    return "heads" if kv_heads is not None and kv_heads % M == 0 else "whole"


def cut_cache(t: torch.Tensor, layout: str, tp: TP) -> torch.Tensor:
    """This rank's share of a whole cache leaf (B, T, ...) in ``layout``:
    its slots (dim 1), its kv heads (dim 2), or all of it."""
    if layout == "whole":
        return t
    d = 1 if layout == "slots" else 2
    n = t.shape[d] // tp.size
    return t.narrow(d, tp.rank * n, n).clone()


def reduce_parts(y: torch.Tensor, rows, tp: TP) -> torch.Tensor:
    """A row-parallel part (its heads' or ffn columns' share of an output
    projection) summed over "model" in float32 and cast once: into the
    rank's ``rows`` (a reduce-scatter), or whole (an all-reduce) where the
    sequence does not split (``rows`` None)."""
    out = (scatter_seq if rows is not None else sum_model)(y.float(), tp)
    return out.to(y.dtype)


def whole_in(h: torch.Tensor, rows, tp: TP) -> torch.Tensor:
    """A block's input whole over the sequence, for the rank's part of its
    heads or ffn columns: gathered where the rows split, else every rank's
    own copy entering the parts (``to_parts``)."""
    return gather_seq(h, tp) if rows is not None else to_parts(h, tp)


def once_whole(tree, defs, tp: TP):
    """The leaves of ``tree`` that "model" does not split (the shapes of
    their ``defs``, a tree of ``ParamDef``s or tensors), each marked so that
    only the axis's rank 0 keeps its gradient (``once_over_model``): for a
    block that every rank computes alike on a sequence that does not split,
    whose replicated leaves the train step's all-reduce over "model" would
    otherwise count M times."""
    if isinstance(tree, dict):
        return {k: once_whole(tree[k], defs[k], tp) for k in tree}
    return once_over_model(tree, tp) if tuple(tree.shape) == tuple(defs.shape) else tree


def gather_stored(tree):
    """``tree`` with each leaf that the train step stores as its "data"
    shard (``stored_params``) all-gathered whole over "data" (its gradient
    reduce-scattered back as a sum over the ranks); every other leaf as it
    is. The identity outside an fsdp step."""
    stored = _STORED.get()
    if stored is None:
        return tree
    dims, axis = stored

    def use(x):
        k = dims.get(id(x))
        return x if k is None else _GatherSeq.apply(x, k, axis)

    return tree_map(use, tree)


def max_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The elementwise max over the ranks (no gradient)."""
    return _all_reduce(x.detach(), tp, dist.ReduceOp.MAX)


def gather_model(x: torch.Tensor, tp: TP, dim: int) -> torch.Tensor:
    """The ranks' pieces along ``dim`` concatenated, without a gradient
    (serving: heads, vocab columns, a prompt's last row)."""
    return _gather(x, dim, tp)


def shard_act(x: torch.Tensor, names: tuple) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None:
        return x
    if len(names) != x.dim():
        raise ValueError(f"axes {names} vs shape {tuple(x.shape)}")
    return x
