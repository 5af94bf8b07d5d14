"""Step builders: assemble (model, optimizer, mesh, shape) into a train,
prefill or decode step with its layouts.

Port of the reference's ``launch/steps.py``. The IPLS mapping of the train
step (``core/sharded.py``):
    grads   -> reduce-scattered over "data" (UpdateModel)
    opt     -> sharded over "data" (responsible-agent update, ZeRO-1)
    params  -> replicated over "data" (all-gather: LoadModel), or sharded
               when fsdp=True (lightweight storage; per-layer gather)
    pod axis-> replica consensus (all-reduce of the gradients)

A ``BuiltStep``'s ``fn`` takes the GLOBAL batch and runs this process's rows
of it (``shard_batch``), as the reference's jitted step takes the global
batch and lets its sharding pick each device's rows. Its specs are tuples
per dim (``core/sharded.py``): ``in_shardings`` and ``out_shardings`` as
the reference's, ``arg_shapes`` ``TensorSpec`` trees of the parameters, the
state or cache, and ``input_specs``, in the port's layouts (one tree per
layer). The model owns its tensors, so the steps take no parameters: the
train ``fn(state, batch)`` returns (state, metrics), the prefill
``fn(batch)`` (logits, cache) and the decode ``fn(cache, batch)`` (logits,
cache), the cache written in place; their specs still list the parameters
first, as the reference's. Prefill and decode run under the mesh context
(``activation_sharding``), so an MoE layer takes the mesh path (one group,
capacity from this rank's B S tokens, float32 combine), as the reference's
built steps do; ``serve_lm.generate``, like the reference's example, runs
meshless and takes the grouped path, so the two differ in capacity by
design. ``build_decode_step(graph=True)`` runs each step on a CUDA device
as one replay of a ``DecodeGraph``: the counterpart of jitting the step.

On a "model" axis above 1 (tensor parallelism: every family) the model
must be built on the mesh (``build_model(cfg, mesh=mesh)``: this rank's
shards of the parameters); the specs are the reference's, of the whole
leaves, and ``arg_shapes`` give this rank's parameters, state and cache
(its batch rows and its share of the cache). A decode step's
context-parallel group is the mesh axes over which its cache specs split
the slots (``kv_seq``): "model", or, past 100,000 slots (the long-context
rules), ("data", "model"), one pod's data x model ranks, a "model" axis of
1 included; a prefill's caches are cut into that layout. A built decode
step whose "model" axis or group is above 1 runs eagerly: ``graph=True``
raises (its collectives would be captured into the graph, which no single
card can check).

With ``IplsStepConfig(fsdp=True)`` (``TRAIN_OVERRIDES`` asks it for the
archs the reference trains so) the state's params are this rank's "data"
shards: ``arg_shapes`` give those, and ``BuiltStep.init_state`` stores a
model's parameters as them in place (``core/sharded.py``
``store_shards``), which frees the whole tensors the shards replace.

``lower_step`` (JAX's ahead-of-time lowering) has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.registry import ShapeSpec, TensorSpec, input_specs
from repro_torch.core.sharded import (
    DEFAULT_RULES,
    IplsStepConfig,
    IplsTrainState,
    gather,
    init_state,
    local_shape,
    make_train_step,
    map_specs,
    mesh_axis_size,
    model_size,
    shard,
    state_shardings,
    store_shards,
    tree_shardings,
)
from repro_torch.kernels._build import Graph
from repro_torch.launch.mesh import dp_axes, make_rules
from repro_torch.models.param_defs import axes_tree
from repro_torch.models.sharding_hooks import activation_sharding
from repro_torch.models.whisper import WhisperModel
from repro_torch.optim.optimizers import Optimizer, adamw
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class BuiltStep:
    fn: Any                       # see the module docstring for each kind's signature
    mesh: Any
    rules: Dict[str, Any]
    in_shardings: Any             # specs (tuples per dim) of (params or state, [cache,] batch)
    out_shardings: Any            # specs of the outputs
    arg_shapes: tuple             # TensorSpec trees of the same arguments
    update_shardings: Any = None  # train: the params' ZeRO-1 specs (owned slices)
    optimizer: Any = None         # train
    fsdp: bool = False            # train: the state's params are the stored "data" shards
    # decode with graph=True: [the current DecodeGraph], shared with ``fn``
    # (which holds no reference to this object: a cycle would keep the
    # model's weights alive until Python's cyclic collector ran)
    graph_slot: Optional[list] = None

    @property
    def decode_graph(self) -> Optional["DecodeGraph"]:
        """The decode graph of the last call (``graph=True``; None before)."""
        return self.graph_slot[0] if self.graph_slot else None

    def init_state(self, params):
        """The train state of ``params`` on this mesh: the optimizer state
        holds this rank's owned slices only. With ``fsdp`` the params are
        stored as this rank's "data" shards: leaves still of the model's
        shapes are cut IN PLACE (``store_shards``: each tensor's data
        replaced by its shard, so ``model.params()`` gives the state's
        params and the whole tensors are freed); leaves of the stored
        shapes (``arg_shapes``) are kept."""
        if self.fsdp:
            want = [s.shape for s in tree_leaves(self.arg_shapes[0].params)]
            if any(tuple(p.shape) != w for p, w in zip(tree_leaves(params), want)):
                store_shards(params, self.update_shardings, self.mesh)
        return init_state(params, self.optimizer, self.update_shardings, self.mesh,
                          fsdp=self.fsdp)


def _batch_shardings(specs: Dict[str, Any], mesh, rules) -> Dict[str, tuple]:
    """Each input's spec, as the reference's: tokens, participation and
    whisper's frames split over the data-parallel axes on dim 0 (the batch),
    M-RoPE's positions3 (3, B, S) on dim 1, each only where the batch
    divides the axes; scalars (decode's ``pos``) replicated."""
    dp = rules.get("batch")
    dp_size = mesh_axis_size(mesh, dp)

    def maybe(n: int):
        return dp if n % dp_size == 0 and n >= dp_size else None

    out = {}
    for name, spec in specs.items():
        if name in ("tokens", "token"):
            out[name] = (maybe(spec.shape[0]), None)
        elif name == "participation":
            out[name] = (maybe(spec.shape[0]),)
        elif name == "positions3":
            out[name] = (None, maybe(spec.shape[1]), None)
        elif name == "enc_embeds":
            out[name] = (maybe(spec.shape[0]), None, None)
        else:
            out[name] = ()
    return out


def _dp_rank(mesh, axes) -> int:
    """This process's index along ``axes`` (row-major, as the reference's
    tuple sharding orders devices)."""
    rank = 0
    for a in axes:
        rank = rank * mesh_axis_size(mesh, a) + mesh.get_local_rank(a)
    return rank


def shard_batch(batch: dict, specs: Dict[str, tuple], mesh) -> dict:
    """This process's part of each input: the slice of the dim that its spec
    splits over the data-parallel axes (positions3's dim 1, the others' dim
    0); the whole input where the spec replicates it or names none."""
    out = {}
    for name, x in batch.items():
        spec = specs.get(name, ())
        dims = [d for d, axes in enumerate(spec) if axes is not None]
        if not dims:
            out[name] = x
            continue
        if len(dims) > 1:
            raise ValueError(f"{name}: spec {spec} splits more than one dim")
        d = dims[0]
        axes = spec[d] if isinstance(spec[d], tuple) else (spec[d],)
        n = x.shape[d] // mesh_axis_size(mesh, axes)
        i = _dp_rank(mesh, axes)
        out[name] = x[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
    return out


def _tensor_specs(tree):
    """A tree of tensors (meta or not) or ``ParamDef``s as ``TensorSpec``s."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def _local_specs(tree, specs, mesh, axes=None):
    """``TensorSpec``s of this rank's shards of a tree under its specs."""
    return map_specs(lambda t, sp: TensorSpec(local_shape(t.shape, sp, mesh, axes), t.dtype),
                     tree, specs)


def _shapes(model):
    """(whole, this rank's) parameter shapes: the specs follow the whole
    leaves, the arguments the rank's shards."""
    local = model.param_shapes()
    whole = model.global_param_shapes() if hasattr(model, "global_param_shapes") else local
    return whole, local


def _check_tp(model, mesh) -> None:
    """A step on a "model" axis above 1 needs the model built on its mesh."""
    if model_size(mesh) == 1:
        return
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("a step on a 'model' mesh axis above 1 needs the model built on that "
                         "mesh: build_model(cfg, mesh=mesh)")


def _members(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _kv_seq_entries(cache_axes, cache_sh) -> set:
    """The distinct mesh axes (tuples) of the ``kv_seq`` dims of a cache's
    specs."""
    out = set()

    def walk(leaf_axes, spec):
        if isinstance(leaf_axes, dict):
            for k in leaf_axes:
                walk(leaf_axes[k], spec[k])
        elif isinstance(leaf_axes, list):
            for a, sp in zip(leaf_axes, spec):
                walk(a, sp)
        elif "kv_seq" in leaf_axes:
            out.add(_members(spec[leaf_axes.index("kv_seq")]))

    walk(cache_axes, cache_sh)
    return out


def _cache_group(cache_axes, cache_sh, mesh) -> tuple:
    """A decode step's context-parallel group: the mesh axes over which its
    cache specs split the slots of the caches that split them (``kv_seq``:
    "model", or ("data", "model") under the long-context rules; () where
    none does). A cache whose slots do not divide the group (a window's
    ring beside a full cache whose slots do, or the reverse), or whose
    batch takes "data", stays whole over its slots, as the reference's
    specs keep it: each rank holds its kv heads or all of them, and that
    layer decodes in its own layout (``TransformerLM.decode_step``, from
    the batch's ``cache_len``). The rules give ``kv_seq`` one set of axes,
    so at most one group is not empty. Size-1 axes count as none."""
    entries = {tuple(a for a in e if mesh_axis_size(mesh, a) > 1)
               for e in _kv_seq_entries(cache_axes, cache_sh)}
    return next(iter(entries - {()}), ())


def _relayout_cache(cache, cache_axes, have, want, mesh):
    """A prefill's cache, whose slots the model splits over "model"
    (``have``), in the decode layout ``want`` where it differs (the
    long-context rules: ``kv_seq`` over ("data", "model"), or kept whole
    where the batch takes "data"): each such leaf gathered whole over
    "model", then cut into this rank's share (its batch rows stay)."""
    def effective(spec):
        return tuple(tuple(a for a in _members(e) if mesh_axis_size(mesh, a) > 1)
                     for e in spec)

    def walk(leaf_axes, t, old, new):
        if isinstance(leaf_axes, dict):
            return {k: walk(leaf_axes[k], t[k], old[k], new[k]) for k in leaf_axes}
        if isinstance(leaf_axes, list):
            return [walk(*z) for z in zip(leaf_axes, t, old, new)]
        if "kv_seq" not in leaf_axes or effective(old) == effective(new):
            return t
        cut = tuple(None if a == "batch" else e for a, e in zip(leaf_axes, new))
        return shard(gather(t, old, mesh, ("model",)), cut, mesh).clone()

    return walk(cache_axes, cache, have, want)


def _rules(mesh, cfg, kind: str, long_context: bool = False,
           extra_rules: Optional[dict] = None) -> dict:
    """The logical -> mesh rules of a step: the defaults, the mesh's for the
    kind of step, the config's overrides, then ``extra_rules``."""
    rules = dict(DEFAULT_RULES, **make_rules(mesh, kind, long_context))
    rules.update(cfg.sharding_overrides)
    rules.update(extra_rules or {})
    return rules


def default_optimizer(total_steps: int = 10000) -> Optimizer:
    return adamw(cosine_warmup(3e-4, 200, total_steps), wd=0.1)


# Per-arch training-step configuration (the reference's, memory-driven): the
# IPLS lightweight-storage (FSDP) mode, params stored partition-sharded over
# "data" and gathered per layer, the paper's "agents store only their own
# partitions + LoadModel on demand". ``IplsStepConfig(**TRAIN_OVERRIDES[arch])``.
TRAIN_OVERRIDES: Dict[str, dict] = {
    "qwen2-vl-72b": {"fsdp": True},
    "deepseek-v2-lite-16b": {"fsdp": True},
}


def build_train_step(
    model,
    mesh,
    shape: ShapeSpec,
    optimizer: Optional[Optimizer] = None,
    step_cfg: Optional[IplsStepConfig] = None,
    extra_rules: Optional[dict] = None,
) -> BuiltStep:
    """The IPLS train step of ``model`` on ``mesh`` for a train ``shape``.
    Its ``fn`` takes the global batch of ``input_specs`` (tokens,
    participation, and whisper's ``enc_embeds`` or M-RoPE's ``positions3``,
    each split by ``shard_batch``) and updates the state's params (the
    model's own tensors when the state holds ``model.params()``) and
    optimizer state in place."""
    cfg = model.cfg
    optimizer = optimizer or default_optimizer()
    num_agents = 1
    for a in dp_axes(mesh):
        num_agents *= mesh_axis_size(mesh, a)
    step_cfg = step_cfg or IplsStepConfig()
    rules = _rules(mesh, cfg, "train", extra_rules=extra_rules)

    specs = input_specs(cfg, shape)
    batch_sh = _batch_shardings(specs, mesh, rules)
    if shape.global_batch % num_agents:
        raise ValueError(
            f"global batch {shape.global_batch} does not split over {num_agents} data ranks"
        )

    def loss_fn(params, batch):
        return model.loss(params, batch)

    # ZeRO-1 (partition-owned) layout of the in-step update: each rank
    # updates its slices and the LoadModel all-gather moves the parameters'
    # dtype, after the cast
    axes, (param_shapes, local_shapes) = model.axes(), _shapes(model)
    update_sh = tree_shardings(axes, param_shapes, mesh, rules, "data")
    raw_step = make_train_step(
        loss_fn, optimizer, step_cfg, num_agents=num_agents, update_shardings=update_sh,
        mesh=mesh,
    )
    state_sh = state_shardings(axes, param_shapes, optimizer, mesh, rules, fsdp=step_cfg.fsdp)
    # the params as the state stores them: the "model" shards, and with fsdp
    # the "data" shard of each of them
    stored = (_local_specs(param_shapes, state_sh.params, mesh) if step_cfg.fsdp
              else _tensor_specs(local_shapes))
    state_shapes = IplsTrainState(
        step=TensorSpec((), torch.int32), params=stored,
        opt_state=_tensor_specs(optimizer.init(local_shapes)), eps=TensorSpec((), torch.float32))
    metrics_sh = dict.fromkeys(("loss", "grad_norm", "participation", "eps"), ())

    def train_step(state, batch):
        _check_tp(model, mesh)
        local = shard_batch(batch, batch_sh, mesh)
        with activation_sharding(mesh, rules):
            return raw_step(state, local)

    return BuiltStep(fn=train_step, mesh=mesh, rules=rules, in_shardings=(state_sh, batch_sh),
                     out_shardings=(state_sh, metrics_sh), arg_shapes=(state_shapes, specs),
                     update_shardings=update_sh, optimizer=optimizer, fsdp=step_cfg.fsdp)


def _cache_shapes_and_axes(model, shape: ShapeSpec):
    """The cache of a shape's batch and sequence (whisper: as many encoder
    frames): its ``TensorSpec`` tree and its axes tree."""
    B, S = shape.global_batch, shape.seq_len
    if isinstance(model, WhisperModel):
        defs = model.cache_defs(B, S, S)
    else:
        defs = model.cache_defs(B, S)
    return _tensor_specs(defs), axes_tree(defs)


def build_prefill_step(model, mesh, shape: ShapeSpec,
                       extra_rules: Optional[dict] = None) -> BuiltStep:
    """The prefill of ``model`` on ``mesh`` for a prefill ``shape``: ``fn(batch)``
    runs this process's rows of the global batch (tokens, and whisper's
    frames or M-RoPE's positions3; an optional host int ``cache_len``, the
    prompt length by default) and returns (last-token logits, cache). The
    cache's specs are in the decode layout, as the reference stores it."""
    cfg = model.cfg
    rules = _rules(mesh, cfg, "prefill", extra_rules=extra_rules)
    param_shapes, local_shapes = _shapes(model)
    param_sh = tree_shardings(model.axes(), param_shapes, mesh, rules)
    batch_specs = input_specs(cfg, shape)
    batch_sh = _batch_shardings(batch_specs, mesh, rules)
    cache_shapes, cache_axes = _cache_shapes_and_axes(model, shape)
    decode_rules = _rules(mesh, cfg, "decode", shape.seq_len > 100_000)
    cache_sh = tree_shardings(cache_axes, cache_shapes, mesh, decode_rules)
    # the model returns its caches split over "model"; the long-context
    # rules split them over ("data", "model")
    model_sh = tree_shardings(cache_axes, cache_shapes, mesh, _rules(mesh, cfg, "decode"))
    relayout = (shape.seq_len > 100_000 and not isinstance(model, WhisperModel)
                and mesh.size() > 1)
    logits_sh = (rules.get("batch"), None, None)

    def prefill_step(batch):
        _check_tp(model, mesh)
        local = shard_batch(batch, batch_sh, mesh)
        with activation_sharding(mesh, rules):
            logits, cache = model.prefill(local)
        if relayout:
            cache = _relayout_cache(cache, cache_axes, model_sh, cache_sh, mesh)
        return logits, cache

    return BuiltStep(fn=prefill_step, mesh=mesh, rules=rules, in_shardings=(param_sh, batch_sh),
                     out_shardings=(logits_sh, cache_sh),
                     arg_shapes=(_tensor_specs(local_shapes), batch_specs))


def build_decode_step(model, mesh, shape: ShapeSpec, extra_rules: Optional[dict] = None,
                      graph: bool = False) -> BuiltStep:
    """One decode step of ``model`` on ``mesh`` for a decode ``shape``:
    ``fn(cache, batch)`` takes this process's cache (a prefill's, or
    ``init_cache``'s) and the global batch (``token`` (B, 1), ``pos`` an int
    or a 0-d int32 tensor) and returns (logits (B_local, 1, V), cache), the
    cache written in place. With ``graph`` the step runs through a
    ``DecodeGraph`` (``decode_graph``, one per cache: a call with another
    cache captures anew): the first call eagerly, then, on a CUDA device,
    each call one replay, its logits the graph's buffer, overwritten by the
    next call. The cache's ``arg_shapes`` are this rank's: its batch rows
    and, where the step's context-parallel group (the axes of ``kv_seq``:
    "model", or ("data", "model") past 100,000 slots) is above 1, its share
    of the slots; there ``graph`` raises. The caches follow their specs one
    by one (split where their slots divide the group, else by kv heads or
    whole), and on a "model" axis or group above 1 the step takes the whole
    caches' sizes as the batch's host ints ``cache_len`` (and whisper's
    ``enc_len``), by default the shape's ``seq_len``, as the declared
    cache."""
    cfg = model.cfg
    long_context = shape.seq_len > 100_000
    rules = _rules(mesh, cfg, "decode", long_context, extra_rules)
    param_shapes, local_shapes = _shapes(model)
    param_sh = tree_shardings(model.axes(), param_shapes, mesh, rules)
    cache_shapes, cache_axes = _cache_shapes_and_axes(model, shape)
    cache_sh = tree_shardings(cache_axes, cache_shapes, mesh, rules)
    whisper = isinstance(model, WhisperModel)
    # whisper's caches take their layouts one by one (models/whisper.py)
    cp_axes = () if whisper else _cache_group(cache_axes, cache_sh, mesh)
    cp_size = mesh_axis_size(mesh, cp_axes) if cp_axes else 1
    if graph and (model_size(mesh) > 1 or cp_size > 1):
        raise NotImplementedError(
            f"a decode graph on a mesh whose 'model' axis or context-parallel group "
            f"({cp_axes}) is above 1 is not ported: its collectives would be captured into "
            f"the CUDA graph, which no single card can check; run the step eagerly "
            f"(graph=False) (ROADMAP.md queue 3)")
    # the step's context: its rules with ``kv_seq`` the group its caches take
    step_rules = dict(rules, kv_seq=(cp_axes if len(cp_axes) > 1 else
                                     cp_axes[0] if cp_axes else None))
    batch_specs = input_specs(cfg, shape)
    batch_sh = _batch_shardings(batch_specs, mesh, rules)
    logits_sh = (rules.get("batch") if shape.global_batch > 1 else None, None, None)

    slot = [None]

    def context():
        return activation_sharding(mesh, step_rules)

    def decode_step(cache, batch):
        _check_tp(model, mesh)
        local = shard_batch(batch, batch_sh, mesh)
        if model_size(mesh) > 1 or cp_size > 1:  # the whole caches' slots: each layer's layout
            local = {"cache_len": shape.seq_len, **({"enc_len": shape.seq_len} if whisper else {}),
                     **local}
        if not graph:
            with context():
                return model.decode_step(cache, local)
        g = slot[0]
        if g is None or g.cache is not cache:
            if g is not None:
                g.close()
            g = slot[0] = DecodeGraph(model, cache, local["token"], local["pos"], context=context)
        else:
            g.set_inputs(local["token"], local["pos"])
        return g.step(), cache

    return BuiltStep(fn=decode_step, mesh=mesh, rules=rules,
                     in_shardings=(param_sh, cache_sh, batch_sh),
                     out_shardings=(logits_sh, cache_sh),
                     arg_shapes=(_tensor_specs(local_shapes),
                                 _local_specs(cache_shapes, cache_sh, mesh), batch_specs),
                     graph_slot=slot if graph else None)


def build_step(model, mesh, shape: ShapeSpec, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(model, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(model, mesh, shape, **kw)
    return build_decode_step(model, mesh, shape, **kw)


class DecodeGraph:
    """A model's decode step on one cache, its inputs in static device
    buffers, run as one CUDA-graph replay: the counterpart of the
    reference's jitted ``decode_step``.

    ``token`` (B, 1) int32 and ``pos`` (0-d int32) hold the step's inputs
    (``set_inputs``). ``step()`` runs ``model.decode_step`` on them, under
    ``context()`` if given (a built step's mesh context), then
    ``after(logits, self)`` if given (``serve_lm.generate``: the greedy
    token written into its output and into ``token``, and ``pos += 1``),
    and returns the logits. The first ``step()`` runs eagerly: a real step,
    and the warm-up of what a capture must not do (building the kernel
    libraries, reading the SM count, filling the layers' cached device
    tensors under the key the capture uses). On a CUDA device it then
    captures one step into a ``kernels/_build.Graph``, which counts the
    kernels of every replay, and each later ``step()`` is one replay that
    returns the captured logits buffer (overwritten by the next replay). A
    capture or a replay that fails raises; nothing carries on eagerly. On
    the CPU, or with ``use_graph=False``, every step runs eagerly. The
    graph replays what the capture saw: a step reads the model's weights and
    config as they were then. ``close()`` frees the graph and its memory
    pool."""

    def __init__(self, model, cache, token, pos, after: Optional[Callable] = None,
                 context: Optional[Callable] = None, use_graph: bool = True):
        dev = model.device
        self.model, self.cache, self.after = model, cache, after
        self.context = context or contextlib.nullcontext
        self.token = torch.zeros(tuple(token.shape), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.set_inputs(token, pos)
        self.use_graph = use_graph and dev.type == "cuda"
        self.graph: Optional[Graph] = None
        self.logits: Optional[torch.Tensor] = None
        self.capture_s = 0.0

    def set_inputs(self, token, pos) -> None:
        """Copy a step's token and pos (an int or a tensor) into the buffers."""
        self.token.copy_(token)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(int(pos))

    @property
    def replays(self) -> int:
        return 0 if self.graph is None else self.graph.replays

    @property
    def launches(self) -> Dict[Callable, int]:
        """Kernel launches a replay makes, by wrapper ({} before the capture)."""
        return {} if self.graph is None else dict(self.graph.launches)

    def _run(self) -> torch.Tensor:
        with self.context():
            logits, _ = self.model.decode_step(self.cache, {"token": self.token, "pos": self.pos})
        if self.after is not None:
            self.after(logits, self)
        return logits

    def step(self) -> torch.Tensor:
        if self.graph is not None:
            self.graph.replay()
            return self.logits
        logits = self._run()
        if self.use_graph:
            torch.cuda.synchronize(self.token.device)
            t0 = time.perf_counter()
            g = Graph()
            with torch.no_grad(), g.capture():
                self.logits = self._run()
            torch.cuda.synchronize(self.token.device)
            self.capture_s = time.perf_counter() - t0
            self.graph = g
        return logits

    def close(self) -> None:
        """Free the graph and its memory pool (the captured logits go with it)."""
        if self.graph is not None:
            self.graph.graph.reset()
        self.graph = self.logits = None
