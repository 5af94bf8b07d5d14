"""FLOPs, bytes, collectives and peak memory of a built step, counted on
fake tensors: the counterpart of the reference's ``roofline/hlo_cost.py``.

The reference parses the step's optimized HLO. The port has no compiled
program to read, so it runs the built step once under
``torch._subclasses.fake_tensor.FakeTensorMode`` (no memory is allocated
and no card is needed, so production shapes cost nothing) with a
``TorchDispatchMode`` that sees every ATen and c10d operation:

* FLOPs: matrix products only (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``_scaled_mm``, the SDPA kernels), at 2 per multiply-accumulate, XLA's
  convention, from ``torch.utils.flop_counter``'s registry, those of
  float32 (or float64) operands apart: they run outside the tensor cores'
  half-precision rate (TF32 stays off). Convolutions and elementwise work
  are left out, as the reference leaves them out.
* bytes: every operation reads its tensor inputs once and writes its
  outputs once. The port runs eagerly, so every operation materialises,
  unlike XLA's fusions. Views (``view``, ``transpose``, ``slice``,
  ``expand``, ...) move nothing. An in-place write into part of a tensor
  (``index_copy_`` of a cache slot, ``copy_`` into a slice) counts the part
  it writes. Factories that only allocate (``empty``) move nothing.
* collectives: the c10d operations the step issues through
  ``torch.distributed`` (``core/sharded.py``'s ``_Plane``), by kind, with
  the reference's ring accounting (``analysis.collective_bytes``). They run
  on a one-process fake process group of the mesh's size
  (``fake_world``), so a (4, 1) or (2, 2, 1) mesh is counted in one
  process.
* peak: the bytes of the step's inputs (parameters, state or cache, batch)
  plus the most that the step's own tensors held at once.

The kernel wrappers take their plain versions on the CPU's fake tensors,
so the FLOPs are the plain path's, as the reference's HLO is its plain
models': flash attention counts every (query, key) pair, masked or not,
and flash-decode every cache slot. A wrapper's call (``kernels/_build.py``
``plain``) counts its bytes as its kernel moves them, each input read once
and each output written once, as XLA counts a fusion; the plain version's
own intermediates (a prefill's (B, H, S, S) scores) are neither bytes nor
memory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.roofline.analysis import HW, HardwareSpec, RooflineReport, collective_bytes
from repro_torch.tree import tree_leaves, tree_map

aten = torch.ops.aten

# the matrix products whose FLOPs count (the registry's other entries are
# convolutions and attention backends the port does not call)
_DOTS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten._scaled_mm,
         aten._scaled_dot_product_efficient_attention,
         aten._scaled_dot_product_flash_attention,
         aten._scaled_dot_product_cudnn_attention)
# c10d operations by collective kind
_COLLECTIVES = {
    "allreduce_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
}
# in-place writes that overwrite (part of) their first argument without
# reading it; those of the second group write the rows of their source
# (the argument at the given index), or of their index for a scalar source
_OVERWRITE = ("copy_", "fill_", "zero_")
_WRITE_SOURCE = {"index_copy_": 3, "index_add_": 3, "scatter_": 3, "index_put_": 2,
                 "masked_scatter_": 2}
# reads of rows by index: the rows read are those written
_GATHER = ("index", "index_select", "embedding", "gather")
# dot operand dtypes at the tensor cores' rate (``HardwareSpec.peak_flops``)
_HALF = (torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float8_e5m2)
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "_unsafe_view", "lift_fresh")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(list(x)))
    return out


def _is_view(func) -> bool:
    """An operation whose output aliases an input without writing it."""
    schema = func._schema
    if any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments):
        return False
    return any(r.alias_info is not None for r in schema.returns)


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0                # dot FLOPs, 2 per multiply-accumulate
    f32_flops: float = 0.0            # the part of them with float32 (or float64) operands
    bytes: float = 0.0                # read and written
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    # each collective call's (kind, group size, in bytes, out bytes), in order
    collective_log: list = dataclasses.field(default_factory=list)
    input_bytes: float = 0.0          # the step's inputs, alive throughout
    peak_bytes: float = 0.0           # input_bytes plus the most the step held at once
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))


class CostMode(TorchDispatchMode):
    """Counts a ``StepCost`` of the operations run under it (see the module
    docstring). Use inside a ``FakeTensorMode``."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._region = 0                  # inside a kernel wrapper's plain version
        self._refs: Dict[int, int] = {}   # storage -> live tensors counted on it
        self._sizes: Dict[int, int] = {}  # storage -> its bytes
        self._live = 0
        self._inputs: set = set()         # storages of the step's inputs

    # -- memory ---------------------------------------------------------------
    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        """Count ``t`` as holding its storage: a ``fresh`` one (a new
        output) from now on, another only if the step made it."""
        key = t.untyped_storage()._cdata
        if key in self._inputs:
            return
        if key not in self._refs:
            if not fresh:
                return
            self._refs[key] = 0
            self._sizes[key] = t.untyped_storage().nbytes()
            self._live += self._sizes[key]
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.cost.input_bytes + self._live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self._live -= self._sizes.pop(key)

    def add_inputs(self, tree) -> None:
        """Count a tree's tensors (unique storages) as the step's inputs."""
        for t in _tensors(tree):
            key = t.untyped_storage()._cdata
            if key not in self._inputs:
                self._inputs.add(key)
                self.cost.input_bytes += t.untyped_storage().nbytes()
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.cost.input_bytes + self._live)

    # -- kernel wrappers ------------------------------------------------------
    def plain(self, name, fn, args, kw):
        """A kernel wrapper's plain version as one pass of its kernel: its
        dots counted, its bytes those of its inputs and outputs."""
        self._region += 1
        try:
            out = fn(*args, **kw)
        finally:
            self._region -= 1
        ins = _tensors(list(args) + list(kw.values()))
        outs = _tensors(out if isinstance(out, (tuple, list)) else [out])
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.cost.bytes += moved
        self.cost.bytes_by_op[name] += moved
        self.cost.kernel_calls[name] += 1
        for t in outs:
            self._track(t, fresh=True)
        return out

    # -- every operation ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if packet in _DOTS:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.cost.flops += flops
            # the operands' dtype: addmm's 1-D bias is not one of them
            if next(t for t in _tensors(list(args)) if t.dim() >= 2).dtype not in _HALF:
                self.cost.f32_flops += flops
        if func.namespace == "c10d":
            return self._collective(name, args, out)
        if self._region:
            return out
        outs = _tensors(out if isinstance(out, (tuple, list)) else [out])
        if _is_view(func) or name in _NO_BYTES:
            for t in outs:
                self._track(t, fresh=False)
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        written = [a for a, s in zip(args, func._schema.arguments)
                   if isinstance(a, torch.Tensor) and s.alias_info is not None
                   and s.alias_info.is_write]
        if not outs and not written:  # a query (device, sizes): no data moves
            return out
        if name in _GATHER:  # reads only the rows it returns
            moved = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif name in _OVERWRITE:
            moved = sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[0])
        elif name in _WRITE_SOURCE:
            src = args[_WRITE_SOURCE[name]]
            part = src if isinstance(src, torch.Tensor) else args[2]  # scatter_ of a value
            moved = sum(_nbytes(t) for t in ins[1:]) + part.numel() * ins[0].element_size()
        elif written:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in written)
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.cost.bytes += moved
        self.cost.bytes_by_op[name] += moved
        for t in outs:
            self._track(t, fresh=not written)
        return out

    def _collective(self, name, args, out):
        kind = _COLLECTIVES.get(name)
        if kind is None:
            if name.startswith(("barrier", "monitored_barrier")):
                return out
            raise NotImplementedError(f"uncounted collective c10d.{name}")
        group = next((a for a in args if isinstance(a, torch.ScriptObject)), None)
        if group is not None and dist.ProcessGroup.unbox(group).size() == 1:
            return out  # a group of one device: nothing crosses a link
        if name in ("allreduce_", "alltoall_"):
            ins = outs = _tensors(args[:1])
        else:  # (output, input, group, ...)
            outs, ins = _tensors(args[:1]), _tensors(args[1:2])
        in_b, out_b = sum(_nbytes(t) for t in ins), sum(_nbytes(t) for t in outs)
        self.cost.collective_bytes[kind] += collective_bytes(kind, in_b, out_b)
        self.cost.collective_log.append((kind, dist.ProcessGroup.unbox(group).size(), in_b, out_b))
        return out


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


@contextlib.contextmanager
def counting(inputs=None):
    """Count the operations run in the block: yields the ``CostMode`` whose
    ``cost`` fills in; kernel wrappers' plain versions count as their
    kernels (``kernels/_build.py``). ``inputs``, a tree, are the step's
    inputs (peak memory). Raises outside a ``FakeTensorMode``: real tensors
    of production shapes would be allocated."""
    if not _fake_mode_active():
        raise RuntimeError("counting needs fake tensors: run it inside fake_world()")
    mode = CostMode()
    if inputs is not None:
        mode.add_inputs(inputs)
    _build.plain_hooks.append(mode.plain)
    try:
        with mode:
            yield mode
    finally:
        _build.plain_hooks.remove(mode.plain)


@contextlib.contextmanager
def fake_world(mesh_shape: Tuple[int, ...] = (1, 1), axes: Optional[Tuple[str, ...]] = None):
    """A ``FakeTensorMode`` entered for the block, which gets a mesh of
    ``mesh_shape`` (axis names ``axes``, by default the reference's:
    ("data", "model") or ("pod", "data", "model")) on a one-process fake
    process group of the mesh's size, this process its rank 0. Models
    built in the block hold fake CPU tensors: nothing is allocated. The
    group is destroyed on exit; an existing process group raises (this
    process would be part of two worlds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists: count steps in a process without one")
    _clear_device_caches()
    axes = axes or (("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model"))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(mesh_shape))
    try:
        mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=tuple(axes))
        with FakeTensorMode(allow_non_fake_inputs=False):
            yield mesh
    finally:
        _clear_device_caches()
        dist.destroy_process_group()


def _clear_device_caches() -> None:
    """Empty the models' per-device constant caches (RoPE frequencies,
    M-RoPE components, whisper's sinusoids): a fake world's entries are
    fake tensors on "cpu", which no other world may read."""
    from repro_torch.models import layers, whisper

    for fn in (layers._rope_freqs_on, layers._mrope_components, whisper._sinusoid_on):
        fn.cache_clear()


def _from_specs(tree):
    """Zero tensors (fake, inside fake_world) of a ``TensorSpec`` tree."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), tree)


def step_inputs(built, kind: str):
    """The arguments of a built step's ``fn``, as fake tensors from its
    ``arg_shapes``: (state, batch) for a train step (the state's optimizer
    slices those this rank owns), (batch,) for a prefill, (cache, batch)
    for a decode step; and the tree that counts as the step's inputs
    (the parameters too, which a prefill and a decode step read from
    their model)."""
    if kind == "train":
        state_specs, batch_specs = built.arg_shapes
        params = _from_specs(state_specs.params)
        state = built.init_state(params)
        batch = _from_specs(batch_specs)
        return (state, batch), (state, batch)
    params = _from_specs(built.arg_shapes[0])  # the model's own: counted, not passed
    if kind == "prefill":
        batch = _from_specs(built.arg_shapes[1])
        return (batch,), (params, batch)
    cache = _from_specs(built.arg_shapes[1])
    batch = _from_specs(built.arg_shapes[2])
    return (cache, batch), (params, cache, batch)


def step_kind(built) -> str:
    if built.optimizer is not None:
        return "train"
    return "decode" if len(built.arg_shapes) == 3 else "prefill"


def count_step(built) -> StepCost:
    """The ``StepCost`` of one call of a built step whose model was built
    in ``fake_world`` (its parameters fake tensors), on fake inputs."""
    args, inputs = step_inputs(built, step_kind(built))
    with counting(inputs) as mode:
        out = built.fn(*args)
        del out
    return mode.cost


def analyze_step(built, hw: HardwareSpec = HW, *, arch: str = "", shape: str = "",
                 model_flops: float = 0.0, cost: Optional[StepCost] = None) -> RooflineReport:
    """The roofline of a built train, prefill or decode step (a
    ``launch/steps.py`` ``BuiltStep`` whose model was built inside
    ``fake_world``): one call counted on fake tensors (``count_step``, or
    ``cost`` if given), its FLOPs and bytes per device times the mesh's
    devices, its collectives per device."""
    cost = cost if cost is not None else count_step(built)
    chips = built.mesh.size() if built.mesh is not None else 1
    dims = built.mesh.mesh_dim_names if built.mesh is not None else ()
    sizes = tuple(built.mesh.shape) if built.mesh is not None else ()
    return RooflineReport(
        arch=arch, shape=shape, mesh="x".join(f"{a}={n}" for a, n in zip(dims, sizes)),
        chips=chips, hlo_flops=cost.flops * chips, hlo_bytes=cost.bytes * chips,
        collective_bytes=dict(cost.collective_bytes), model_flops=model_flops,
        hlo_flops_f32=cost.f32_flops * chips,
        peak_bytes_per_device=cost.peak_bytes, hw=hw)


@dataclasses.dataclass
class CellCount:
    """One step counted on a fake mesh (``count_cell_step``): its report and
    counts, and the seconds it took to build the model and the step
    (``build_s``) and to count one call (``count_s``)."""
    report: RooflineReport
    cost: StepCost
    build_s: float
    count_s: float


def count_cell_step(cfg, arch: str, shape, mesh_shape: Tuple[int, ...] = (1, 1),
                    step_cfg=None, enc_len: Optional[int] = None) -> CellCount:
    """Build ``cfg``'s model and its step for ``shape`` (a ``ShapeSpec``) in
    ``fake_world(mesh_shape)`` (the rank's shards where the "model" axis is
    above 1; a train step takes ``step_cfg``) and count one call. With
    ``enc_len`` a whisper decode step's cross caches hold that many frames.
    The one counting path of ``python -m repro_torch.roofline`` and of the
    dry run (``launch/dryrun.py``)."""
    from repro_torch.configs import build_model
    from repro_torch.configs.registry import TensorSpec
    from repro_torch.launch import steps
    from repro_torch.models.whisper import WhisperConfig
    from repro_torch.roofline.analysis import model_flops_for

    t0 = time.perf_counter()
    with fake_world(tuple(mesh_shape)) as mesh:
        model = build_model(cfg, device="cpu", mesh=mesh if mesh_shape[-1] > 1 else None)
        kw = {"step_cfg": step_cfg} if step_cfg is not None else {}
        built = steps.build_step(model, mesh, shape, **kw)
        if isinstance(cfg, WhisperConfig) and shape.kind == "decode" and enc_len:
            cache = tree_map(lambda d: TensorSpec(tuple(d.shape), d.dtype),
                             model.cache_defs(shape.global_batch, shape.seq_len, enc_len))
            built = dataclasses.replace(built, arg_shapes=(built.arg_shapes[0], cache,
                                                           built.arg_shapes[2]))
        mf = model_flops_for(model, shape.kind, shape.seq_len, shape.global_batch)
        t1 = time.perf_counter()
        cost = count_step(built)
        report = analyze_step(built, arch=arch, shape=shape.name, model_flops=mf, cost=cost)
    return CellCount(report, cost, t1 - t0, time.perf_counter() - t1)
