"""IPLS on a device mesh: the paper's protocol as explicit collectives.

Port of the reference's ``core/sharded.py``. The mapping is the same:

  agent                    = a data-parallel rank (mesh axis "data")
  partition w_k            = the 1/|data| slice of each parameter leaf
  UpdateModel (send delta) = reduce-scatter of grads over "data"
  responsible-agent update = optimizer update of the owned slice only
                             (optimizer state sharded over "data" = ZeRO-1)
  LoadModel (fetch parts)  = all-gather of the updated slices over "data"
  replication rho          = the "pod" mesh axis: every pod holds a replica
                             of every partition; replica consensus =
                             all-reduce of the gradients over "pod"
  staleness weight eps     = w <- w - eps * update,
                             eps <- alpha*eps + (1-alpha)/r, r = #participants

The reference states the layout as GSPMD shardings and lets XLA insert the
collectives. Here they are explicit calls on the mesh's process groups
(``torch.distributed`` ``reduce_scatter_tensor``, ``all_reduce``,
``all_gather_into_tensor``), one process per device. The layout comes from
the same logical-axis metadata: every parameter leaf carries one logical
axis name per dim, ``spec_for_leaf`` maps them to mesh axes by rules, and
ZeRO-1 adds "data" on the first free, divisible dim. A spec is a tuple with
one entry per dim: None (replicated), a mesh axis name, or a tuple of them
(the counterpart of a ``PartitionSpec``).

Tensor parallelism: on a "model" axis above 1 every rank holds the local
shard of each parameter leaf that its spec gives over "model" (heads, ffn
columns and rows, vocab rows; a dim that does not divide the axis leaves
the leaf replicated, as in the reference), ``shard`` / ``gather`` /
``local_shape`` being the layout of a spec. The model's activations carry
the explicit layout changes (``models/sharding_hooks.py``); here the
gradient of a leaf replicated over "model" is all-reduced over it (every
such rank's gradient is a partial sum: it saw its own rows of the
sequence, or its own heads), ZeRO-1's owned slices are cut inside the
rank's "model" shard, and the clip's global norm counts each element once.

FSDP (``IplsStepConfig(fsdp=True)``, the paper's storage mode: an agent
stores only its partitions and loads the model on demand): the state's
params hold this rank's "data" shard of every leaf whose fsdp spec splits
it, which is exactly its ZeRO-1 owned slice (``store_shards``); the loss
runs under ``sharding_hooks.stored_params``, and the models gather each
layer's leaves over "data" inside the layer's checkpoint (the backward
reduce-scatters their gradients: UpdateModel happens there), so no
LoadModel all-gather follows the update. A leaf with no dim that divides
"data" stays whole and takes the ZeRO-1 path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from collections.abc import Mapping
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import Optimizer, clip_scale, sum_in_order
from repro_torch.optim.schedules import fdiv
from repro_torch.telemetry.timing import NULL_TIMER, device_phase
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# ---------------------------------------------------------------------------
# logical-axis sharding
# ---------------------------------------------------------------------------

# default rules: logical axis name -> mesh axis (None = replicate)
DEFAULT_RULES: dict = {
    "vocab": "model",
    "embed": None,          # d_model rows replicated; vocab cols sharded
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "ffn": "model",
    "experts": "model",     # expert dim sharded over model (expert parallel)
    "expert_ffn": None,
    "layers": None,          # stacked-scan leading axis
    "conv": None,
    "ssm": None,
    "batch": "data",
    "seq": None,
    "act_seq": "model",     # sequence-parallel residual stream between blocks
    "kv_seq": "model",      # context-parallel KV cache for decode
    "any": None,
}


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping that gives
    them (a mesh's shape without its processes, for specs)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, name) -> int:
    """Size of a mesh axis; a tuple like ("pod", "data") multiplies."""
    if name is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(name, tuple):
        size = 1
        for n in name:
            size *= sizes[n]
        return size
    return sizes[name]


def _members(m) -> tuple:
    return m if isinstance(m, tuple) else (m,)


def spec_for_leaf(axes, shape, mesh, rules: dict, zero1_axis: Optional[str] = None) -> tuple:
    """Map a leaf's logical axes to a spec (one mesh axis, tuple of them, or
    None per dim).

    With ``zero1_axis`` (usually "data"), also shard the first dim that is
    either unsharded after the rules and divisible by that axis's size, or
    sharded and divisible by both sizes (then sub-sharded): the IPLS
    partition-ownership layout of grads, optimizer state and FSDP storage.
    """
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} vs shape {shape}")
    mapped: List[Any] = []
    used = set()
    for ax, dim in zip(axes, shape):
        m = rules.get(ax) if ax is not None else None
        if (
            m is not None
            and not (set(_members(m)) & used)
            and dim % mesh_axis_size(mesh, m) == 0
            and dim > 0
        ):
            mapped.append(m)
            used.update(_members(m))
        else:
            mapped.append(None)
    if zero1_axis is not None and zero1_axis not in used:
        zsize = mesh_axis_size(mesh, zero1_axis)
        for i, (cur, dim) in enumerate(zip(mapped, shape)):
            if cur is None and dim % zsize == 0 and dim >= zsize:
                mapped[i] = zero1_axis
                break
            if cur is not None and dim % (mesh_axis_size(mesh, cur) * zsize) == 0:
                mapped[i] = _members(cur) + (zero1_axis,)
                break
    return tuple(mapped)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, (str, tuple)) for a in x)


def _map_axes(fn, axes_tree, other):
    """``fn(axes, leaf)`` over an axes tree (leaves: tuples of axis names)
    and a tree of the same dict/list structure."""
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, axes_tree[k], other[k]) for k in axes_tree}
    if isinstance(axes_tree, list):
        return [_map_axes(fn, a, o) for a, o in zip(axes_tree, other)]
    if not _is_axes(axes_tree):
        raise TypeError(f"not an axes tuple: {axes_tree!r}")
    return fn(axes_tree, other)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_shardings(axes_tree, shape_tree, mesh, rules: Optional[dict] = None,
                   zero1_axis: Optional[str] = None):
    """The spec of every leaf of a params-like tree, from its axes tree and
    its shapes (tensors, meta tensors or shape tuples)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    return _map_axes(
        lambda axes, shp: spec_for_leaf(axes, _shape(shp), mesh, rules, zero1_axis),
        axes_tree, shape_tree,
    )


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------


class IplsTrainState(NamedTuple):
    step: torch.Tensor       # () int32
    params: Any              # tree, compute layout (this rank's "model" shards)
    opt_state: Any           # tree, ZeRO-1: each rank's owned slices
    eps: torch.Tensor        # () float32 staleness weight (paper's epsilon)


@dataclasses.dataclass(frozen=True)
class IplsStepConfig:
    alpha: float = 0.5        # eps smoothing (paper)
    use_eps: bool = True      # False => plain data-parallel training (eps == 1)
    fsdp: bool = False        # store params sharded over "data", gathered per layer
    grad_clip: Optional[float] = 1.0
    accum_steps: int = 1      # microbatch accumulation


def owned_dim(spec) -> Optional[int]:
    """The dim of a ZeRO-1 spec that "data" shards, or None."""
    if spec is None:
        return None
    for i, m in enumerate(spec):
        if m is not None and "data" in _members(m):
            return i
    return None


# ---------------------------------------------------------------------------
# the local-shard layout of a spec
# ---------------------------------------------------------------------------


def _split_axes(entry, axes) -> tuple:
    """The mesh axes of a spec entry that split a dim among ``axes`` (None:
    all of them): its leading members in ``axes``. A member in ``axes``
    after one that is not would cut the dim into strided pieces, which no
    layout here uses."""
    members = _members(entry) if entry is not None else ()
    taken = []
    for i, a in enumerate(members):
        if axes is not None and a not in axes:
            if any(b in axes for b in members[i + 1:]):
                raise NotImplementedError(f"spec entry {entry}: {axes} is not a leading part")
            break
        taken.append(a)
    return tuple(taken)


def _axis_rank(mesh, axes: tuple) -> int:
    """This process's row-major index over ``axes`` (a composite entry's
    first axis the major one, as a PartitionSpec orders devices)."""
    rank = 0
    for a in axes:
        rank = rank * mesh_axis_size(mesh, a) + mesh.get_local_rank(a)
    return rank


def local_shape(shape, spec, mesh, axes=None) -> tuple:
    """The shape of this rank's shard of a leaf of ``shape`` under ``spec``,
    counting only the mesh axes in ``axes`` (None: every axis of the spec)."""
    out = list(shape)
    for i, entry in enumerate(spec or ()):
        n = mesh_axis_size(mesh, _split_axes(entry, axes))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split {n} ways (spec {spec})")
        out[i] //= n
    return tuple(out)


def global_shape(shape, spec, mesh, axes=None) -> tuple:
    """The whole leaf's shape from a shard's (``local_shape``'s inverse)."""
    return tuple(n * mesh_axis_size(mesh, _split_axes(e, axes))
                 for n, e in zip(shape, tuple(spec or ()) + (None,) * len(shape)))


def shard(x: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """This rank's shard (a view) of a whole leaf ``x`` under ``spec``, over
    the mesh axes in ``axes`` (None: all)."""
    for i, entry in enumerate(spec or ()):
        split = _split_axes(entry, axes)
        if split:
            n = x.shape[i] // mesh_axis_size(mesh, split)
            x = x.narrow(i, _axis_rank(mesh, split) * n, n)
    return x


def call_collective(fn, *args, **kw) -> None:
    """A ``torch.distributed`` call (newer torch renames these calls and
    warns; both names work)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(*args, **kw)


def all_gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' pieces of ``x`` concatenated along ``dim`` in rank
    order (one ``all_gather_into_tensor``)."""
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] * n,) + tuple(moved.shape[1:]))
    call_collective(dist.all_gather_into_tensor, out, moved, group=group)
    return out.movedim(0, dim)


def gather(x: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """The whole leaf (over the mesh axes in ``axes``, None: all) from every
    rank's shard ``x`` under ``spec``: all-gathers over each splitting axis,
    the minor one first. Every rank of those axes must call it."""
    for i, entry in enumerate(spec or ()):
        for a in reversed(_split_axes(entry, axes)):
            n = mesh_axis_size(mesh, a)
            if n > 1:
                x = all_gather_dim(x, i, mesh.get_group(a), n)
    return x


def _splits_over(spec, axis: str) -> bool:
    return any(e is not None and axis in _members(e) for e in (spec or ()))


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (dicts, lists, tuples such as a train
    state or an ``AdamLeaf``) and its spec tree (leaves: tuples of mesh
    axes per dim), into a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, list):
        return [map_specs(fn, t, s) for t, s in zip(tree, specs)]
    if isinstance(tree, tuple):
        out = [map_specs(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, specs)


def shard_tree(tree, specs, mesh, axes=("model",)):
    """Every leaf's shard (``shard``) over ``axes``."""
    return map_specs(lambda x, s: shard(x, s, mesh, axes), tree, specs)


def gather_tree(tree, specs, mesh, axes=("model",)):
    """Every leaf whole over ``axes`` (``gather``; collective on every rank)."""
    return map_specs(lambda x, s: gather(x, s, mesh, axes), tree, specs)


def model_size(mesh) -> int:
    """The size of a mesh's "model" axis (1 without a mesh or the axis)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return mesh_axis_size(mesh, "model")


class _Plane:
    """The collectives of the train step on a mesh's process groups, or
    none (``mesh=None``: one process, every collective the identity).

    ``dims`` is each leaf's owned dim (in ``tree_leaves`` order), None
    for a leaf with no dim over "data" (reduced and updated whole on every
    rank). On a "model" axis above 1 (``model`` its group), ``split`` says
    which leaves it shards (the others' gradients are partial sums over
    it); the owned slice is cut inside the rank's "model" shard. With
    ``stored`` (fsdp) a leaf with an owned dim is its owned slice already,
    and its gradient arrives summed over "data"."""

    def __init__(self, mesh, specs, n_leaves: int, stored: bool = False):
        self.stored = stored
        self.D, self.d, self.P, self.p = 1, 0, 1, 0
        self.data = self.pod = self.model = None
        self.split = [False] * n_leaves
        if mesh is not None:
            names = mesh.mesh_dim_names
            if model_size(mesh) > 1:
                self.model = mesh.get_group("model")
                if specs is not None:
                    self.split = [_splits_over(s, "model") for s in specs]
            self.data = mesh.get_group("data")
            self.D, self.d = mesh_axis_size(mesh, "data"), mesh.get_local_rank("data")
            if "pod" in names:
                self.pod = mesh.get_group("pod")
                self.P, self.p = mesh_axis_size(mesh, "pod"), mesh.get_local_rank("pod")
        self.dims = [owned_dim(s) for s in specs] if specs is not None else [None] * n_leaves

    @property
    def dp_rank(self) -> int:
        return self.p * self.D + self.d

    @property
    def dp_size(self) -> int:
        return self.P * self.D

    _call = staticmethod(call_collective)

    def all_reduce_dp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every data-parallel rank (data, then pod), in place."""
        for g in (self.data, self.pod):
            if g is not None:
                self._call(dist.all_reduce, x, group=g)
        return x

    @property
    def data_axis(self):
        """The "data" axis as ``sharding_hooks.TP`` takes it (group, size,
        rank), or None on a data axis of 1."""
        from repro_torch.models.sharding_hooks import TP

        return None if self.data is None or self.D == 1 else TP(self.data, self.D, self.d)

    def owned(self, p: torch.Tensor, k: Optional[int]) -> torch.Tensor:
        """This rank's slice of a full leaf (a view); a stored leaf is it."""
        if k is None or self.stored:
            return p
        n = p.shape[k] // self.D
        return p.narrow(k, self.d * n, n)

    def reduce_grad(self, g: torch.Tensor, k: Optional[int], split: bool = True) -> torch.Tensor:
        """UpdateModel: this rank's owned slice of the sum over ranks of
        ``g`` (reduce-scatter over "data", all-reduce over "pod"), or the
        whole sum for a leaf with no owned dim; a leaf that the "model"
        axis does not ``split`` is first summed over it. A stored leaf's
        ``g`` is its slice summed over "data" already (the backward of its
        gather), which only "model" and "pod" still sum. Contiguous, in the
        leaf's layout."""
        if self.model is not None and not split:
            self._call(dist.all_reduce, g, group=self.model)
        if k is None:
            return self.all_reduce_dp(g)
        if self.stored:
            if self.pod is not None:
                self._call(dist.all_reduce, g, group=self.pod)
            return g
        moved = g.movedim(k, 0).contiguous() if k else g
        out = moved.new_empty((moved.shape[0] // self.D,) + tuple(moved.shape[1:]))
        if self.data is not None:
            self._call(dist.reduce_scatter_tensor, out, moved, group=self.data)
        else:
            out.copy_(moved)
        if self.pod is not None:
            self._call(dist.all_reduce, out, group=self.pod)
        return out.movedim(0, k).contiguous() if k else out

    def load(self, p: torch.Tensor, new: torch.Tensor, k: Optional[int]) -> None:
        """LoadModel: write every rank's updated slice into the full leaf
        ``p`` (all-gather over "data", in ``p``'s dtype); a stored leaf
        takes its slice and nothing is gathered."""
        if k is None or self.data is None or self.stored:
            p.copy_(new)
            return
        if k == 0 and p.is_contiguous():
            self._call(dist.all_gather_into_tensor, p, new.contiguous(), group=self.data)
            return
        moved = new.movedim(k, 0).contiguous()
        full = moved.new_empty((moved.shape[0] * self.D,) + tuple(moved.shape[1:]))
        self._call(dist.all_gather_into_tensor, full, moved, group=self.data)
        p.copy_(full.movedim(0, k))


def _device_of(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def store_shards(params, update_shardings, mesh) -> None:
    """fsdp storage, IN PLACE: every leaf of ``params`` (this rank's
    "model" shards) with an owned dim under its ZeRO-1 spec
    (``update_shardings``) keeps only its owned slice, its tensor's data
    replaced by a copy of that slice (``p.data = ...``), so the whole leaf
    is freed once nothing else holds it and a module whose parameters these
    are holds the shards. On a data axis of 1 nothing changes."""
    leaves = tree_leaves(params)
    plane = _Plane(mesh, tree_leaves_of_specs(update_shardings, params), len(leaves))
    if plane.D == 1:
        return
    for p, k in zip(leaves, plane.dims):
        if k is not None:
            p.data = plane.owned(p.data, k).clone()


def init_state(params, optimizer: Optimizer, update_shardings=None, mesh=None,
               fsdp: bool = False) -> IplsTrainState:
    """The train state of ``params`` (kept, not copied: the step updates
    them in place). With ``update_shardings`` (the ZeRO-1 specs) and a
    mesh, the optimizer state holds only this rank's owned slices; with
    ``fsdp`` the params are the stored slices (``store_shards``)
    already."""
    leaves = tree_leaves(params)
    specs = tree_leaves_of_specs(update_shardings, params) if update_shardings is not None else None
    plane = _Plane(mesh, specs, len(leaves), stored=fsdp and mesh is not None)
    owned = tree_unflatten(params, [plane.owned(p, k) for p, k in zip(leaves, plane.dims)])
    dev = _device_of(params)
    return IplsTrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        params=params,
        opt_state=optimizer.init(owned),
        eps=torch.ones((), dtype=torch.float32, device=dev),
    )


def tree_leaves_of_specs(specs_tree, like) -> list:
    """The specs of a spec tree (leaves: tuples) in ``tree_leaves(like)``
    order, ``like`` being the params tree they describe."""
    out: list = []

    def walk(s, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(s[k], t[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(s, t):
                walk(a, b)
        else:
            out.append(s)

    walk(specs_tree, like)
    return out


def _microbatch(batch: dict, j: int, size: int) -> dict:
    return {k: v[j * size:(j + 1) * size] for k, v in batch.items()}


def make_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    cfg: IplsStepConfig = IplsStepConfig(),
    num_agents: Optional[int] = None,
    update_shardings: Any = None,
    mesh=None,
    timer=NULL_TIMER,
):
    """Build the IPLS train step ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> (per_example_loss (B,), aux)``, differentiable
    by autograd. ``batch`` holds this rank's rows of the global batch (all
    of it without a mesh), including ``participation``: a (B,) float mask,
    constant within each agent's sub-batch; dropped agents contribute
    nothing, and r (the number of participants) feeds the eps update.

    The semantics are the reference's: the loss is the participation-masked
    mean over the global batch, divided by the global count of
    participants (an all-reduce of the mask sums); with ``accum_steps`` = A
    the global batch splits into A microbatches, each a masked mean of its
    own, and the step averages them, as the reference's accumulation does.
    Each rank runs its rows in A pieces (each within one of those
    microbatches), so its memory is that of B / A rows. Then UpdateModel
    (reduce-scatter over "data"; all-reduce over "pod"), the global-norm
    clip (the owned slices' squares summed over "data", a leaf without an
    owned dim counted once), the optimizer on the owned slices (its state
    sharded: ZeRO-1), the eps recursion, the update ``(p32 - eps * u)`` cast
    to the parameter's dtype, and LoadModel (all-gather of the updated
    slices). ``update_shardings`` (the ZeRO-1 specs of the params) says
    which slice each rank owns; without it every leaf is reduced and
    updated whole. On a "model" axis above 1 the params are this rank's
    "model" shards (``loss_fn`` runs under the step's mesh context, every
    rank of the axis returning the whole loss), the gradient of a leaf the
    axis does not split is first summed over it, the owned slice is cut
    inside the shard, and the clip's norm sums the split leaves' squares
    over the axis too.

    The parameters are updated IN PLACE (the state's ``params`` tensors are
    the returned state's), and so is the optimizer state. With
    ``mesh=None`` every collective is skipped; on a mesh of one device they
    run on a world of one and give the same bits.

    With ``cfg.fsdp`` on a mesh the state's params are the stored "data"
    shards (``store_shards``, ``init_state(..., fsdp=True)``) and
    ``loss_fn`` runs under ``sharding_hooks.stored_params``: the model
    gathers each stored leaf where it uses it, and the backward of that
    gather reduce-scatters the leaf's gradient over "data" in the
    gradient's dtype (the parameter's), before the float32 accumulation of
    A > 1 pieces, as the reference accumulates sharded gradients. The
    update then adds no reduce-scatter (only the all-reduces over "pod" and,
    for leaves it does not split, "model"), and writes ``p32 - eps * u``
    into the stored shard, with no all-gather. On a data axis of 1 the
    gathers are the identity and the step is bit for bit the one without
    fsdp. ``timer`` (a
    ``telemetry.PhaseTimer``) times the phases ``forward``, ``backward``
    and ``update`` (everything after the gradients: the collectives, the
    clip, the optimizer, the apply), synchronized at each phase's end.
    """
    A = cfg.accum_steps
    stored = cfg.fsdp and mesh is not None

    def gradients(params, leaves, batch, plane, dev):
        """This rank's gradient of its rows (a float32 sum over its pieces
        when A > 1), its share of the loss, and the participant counts of
        the reference's A microbatches (all-reduced)."""
        B = next(iter(batch.values())).shape[0]
        mask = batch.get("participation")
        if mask is None:
            mask = torch.ones((B,), dtype=torch.float32, device=dev)
            batch["participation"] = mask
        if B % A:
            raise ValueError(f"batch of {B} rows does not split into {A} microbatches")
        mb = B // A
        # the reference's microbatch (of the global batch) of each local piece
        glob_mb = B * plane.dp_size // A
        ref_mb = [(plane.dp_rank * B + j * mb) // glob_mb for j in range(A)]
        counts = torch.zeros((A,), dtype=torch.float32, device=dev)
        for j in range(A):
            counts[ref_mb[j]] += mask[j * mb:(j + 1) * mb].float().sum()
        plane.all_reduce_dp(counts)

        alias = [p.detach().requires_grad_(True) for p in leaves]
        alias_tree = tree_unflatten(params, alias)
        storage = contextlib.nullcontext
        if plane.stored and plane.data_axis is not None:
            from repro_torch.models.sharding_hooks import stored_params

            dims = {id(a): k for a, k in zip(alias, plane.dims) if k is not None}
            storage = functools.partial(stored_params, dims, plane.data_axis)
        for j in range(A):
            piece = _microbatch(batch, j, mb) if A > 1 else batch
            with device_phase(timer, "forward", dev), storage():
                per_ex, _aux = loss_fn(alias_tree, piece)
                m = piece["participation"].to(per_ex.dtype)
                piece_loss = torch.sum(per_ex * m) / counts[ref_mb[j]].clamp_min(1.0)
            with device_phase(timer, "backward", dev):
                got = torch.autograd.grad(piece_loss, alias, allow_unused=True)
            got = [torch.zeros_like(p) if g is None else g for g, p in zip(got, leaves)]
            if j == 0:  # the reference accumulates microbatches in float32 from zeros
                grads = got if A == 1 else [torch.zeros_like(g, dtype=torch.float32) + g
                                            for g in got]
                loss_acc = piece_loss.detach()
            else:
                grads = [acc + g for acc, g in zip(grads, got)]
                loss_acc = loss_acc + piece_loss.detach()
            del per_ex, piece_loss, got
        return grads, loss_acc, counts, glob_mb

    def update(state, leaves, grads, loss_acc, counts, glob_mb, plane, dev):
        """UpdateModel, the clip, the owned update, eps and LoadModel."""
        params = state.params
        loss = plane.all_reduce_dp(loss_acc)
        frac_parts = [fdiv(counts[i], glob_mb) for i in range(A)]
        if A > 1:
            loss = fdiv(loss, A)
            frac = fdiv(sum_in_order([torch.zeros((), device=dev)] + frac_parts), A)
        else:
            frac = frac_parts[0]

        # UpdateModel: each rank keeps the sum over ranks of its owned slices
        owned_g = []
        for i, k in enumerate(plane.dims):
            g = plane.reduce_grad(grads[i].contiguous(), k, plane.split[i])
            grads[i] = None
            owned_g.append(fdiv(g, A) if A > 1 else g)

        # the global norm: owned slices' squares summed over "data", and
        # over "model" for the leaves it splits (each element counted once)
        sq = [g.float().square().sum() for g in owned_g]
        for group, ix in ((plane.data, [i for i, k in enumerate(plane.dims) if k is not None]),
                          (plane.model, [i for i, s in enumerate(plane.split) if s])):
            if group is not None and ix:
                summed = torch.stack([sq[i] for i in ix])
                plane._call(dist.all_reduce, summed, group=group)
                for n, i in enumerate(ix):
                    sq[i] = summed[n]
        gnorm = torch.sqrt(sum_in_order(sq))
        if cfg.grad_clip is not None:
            scale = clip_scale(gnorm, cfg.grad_clip)
            owned_g = [g * scale.to(g.dtype) for g in owned_g]

        # the responsible agent's update of its owned slices (ZeRO-1)
        owned_p = [plane.owned(p, k) for p, k in zip(leaves, plane.dims)]
        updates, new_opt = optimizer.update(
            tree_unflatten(params, owned_g), state.opt_state,
            tree_unflatten(params, owned_p), state.step,
        )
        del owned_g
        if cfg.use_eps:
            # eps tracks 1/r and weights the SUM of the r contributions; the
            # grads are the masked MEAN, so the applied scale is eps * r
            # (1.0 in steady state, FedAvg; under churn eps lags r)
            n = num_agents if num_agents is not None else 1
            r = (frac * n).clamp_min(1.0)
            new_eps = cfg.alpha * state.eps + torch.full_like(r, 1.0 - cfg.alpha) / r
            eps = new_eps * r
        else:
            eps = torch.ones((), dtype=torch.float32, device=dev)
            new_eps = state.eps

        # update of the owned slice, then LoadModel in the params' dtype
        upd = tree_leaves(updates)
        del updates
        with torch.no_grad():
            for i, (p, k) in enumerate(zip(leaves, plane.dims)):
                new = (owned_p[i].float() - eps * upd[i].float()).to(p.dtype)
                upd[i] = None
                plane.load(p, new, k)

        new_state = IplsTrainState(step=state.step + 1, params=params, opt_state=new_opt,
                                   eps=new_eps)
        metrics = {"loss": loss, "grad_norm": gnorm, "participation": frac, "eps": new_eps}
        return new_state, metrics

    def train_step(state: IplsTrainState, batch):
        params = state.params
        leaves = tree_leaves(params)
        specs = (tree_leaves_of_specs(update_shardings, params)
                 if update_shardings is not None else None)
        plane = _Plane(mesh, specs, len(leaves), stored=stored)
        dev = _device_of(params)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        grads, loss_acc, counts, glob_mb = gradients(params, leaves, batch, plane, dev)
        with device_phase(timer, "update", dev):
            return update(state, leaves, grads, loss_acc, counts, glob_mb, plane, dev)

    return train_step


def _opt_specs(opt_state, zero1):
    """The optimizer state's specs: each state leaf takes its parameter's
    ZeRO-1 spec (an AdamLeaf one per moment)."""
    if isinstance(zero1, dict):
        return {k: _opt_specs(opt_state[k], zero1[k]) for k in zero1}
    if isinstance(zero1, list):
        return [_opt_specs(o, z) for o, z in zip(opt_state, zero1)]
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        return type(opt_state)(*(zero1 for _ in opt_state))
    return zero1


def state_shardings(axes_tree, params_shapes, optimizer: Optimizer, mesh,
                    rules: Optional[dict] = None, fsdp: bool = False) -> IplsTrainState:
    """The specs of the whole IplsTrainState.

    params: compute layout (tensor-parallel over "model"; + "data" when
    fsdp); opt_state: ZeRO-1, always + "data" (the IPLS partition
    ownership); step and eps: replicated scalars. ``params_shapes`` may be
    meta tensors (``model.param_shapes()``)."""
    param_sh = tree_shardings(axes_tree, params_shapes, mesh, rules, "data" if fsdp else None)
    zero1 = tree_shardings(axes_tree, params_shapes, mesh, rules, "data")
    # fsdp stores each rank's owned slice: the two layouts are one
    assert not fsdp or param_sh == zero1, "the fsdp specs differ from the ZeRO-1 specs"
    meta = tree_map(lambda t: torch.empty(_shape(t), device="meta"), params_shapes)
    opt_state = optimizer.init(meta)
    opt_sh = () if opt_state == () else _opt_specs(opt_state, zero1)
    return IplsTrainState(step=(), params=param_sh, opt_state=opt_sh, eps=())
