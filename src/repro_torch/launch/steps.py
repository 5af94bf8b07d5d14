"""Step builders: assemble (model, optimizer, mesh, shape) into a train step
with its layouts.

Port of the reference's ``launch/steps.py`` for ``kind == "train"``. The
IPLS mapping (``core/sharded.py``):
    grads   -> reduce-scattered over "data" (UpdateModel)
    opt     -> sharded over "data" (responsible-agent update, ZeRO-1)
    params  -> replicated over "data" (all-gather: LoadModel)
    pod axis-> replica consensus (all-reduce of the gradients)

A ``BuiltStep``'s ``fn(state, batch)`` takes the GLOBAL batch and runs this
process's rows of it (``shard_batch``), as the reference's jitted step
takes the global batch and lets its sharding pick each device's rows. The
specs it carries are tuples per dim (``core/sharded.py``). The prefill and
decode builders, ``lower_step`` (JAX's ahead-of-time lowering) and the
layouts and per-arch step overrides (``TRAIN_OVERRIDES``) that only they
and the dry run read are not ported (ROADMAP.md); the configs' sharding
overrides are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.configs.registry import ShapeSpec, input_specs
from repro_torch.core.sharded import (
    DEFAULT_RULES,
    IplsStepConfig,
    init_state,
    make_train_step,
    mesh_axis_size,
    tree_shardings,
)
from repro_torch.launch.mesh import dp_axes, make_rules
from repro_torch.models.sharding_hooks import activation_sharding
from repro_torch.optim.optimizers import Optimizer, adamw
from repro_torch.optim.schedules import cosine_warmup


@dataclasses.dataclass
class BuiltStep:
    fn: Any                       # fn(state, global batch) -> (state, metrics)
    mesh: Any
    rules: Dict[str, Any]
    update_shardings: Any         # the params' ZeRO-1 specs (owned slices)
    optimizer: Any

    def init_state(self, params):
        """The train state of ``params`` on this mesh: the optimizer state
        holds this rank's owned slices only."""
        return init_state(params, self.optimizer, self.update_shardings, self.mesh)


def _batch_shardings(specs: Dict[str, Any], mesh, rules) -> Dict[str, tuple]:
    """Each train input's rows over the data-parallel axes (when the batch
    divides them), its other dims replicated."""
    dp = rules.get("batch")
    dp_size = mesh_axis_size(mesh, dp)
    out = {}
    for name, spec in specs.items():
        rows = dp if spec.shape[0] % dp_size == 0 and spec.shape[0] >= dp_size else None
        out[name] = (rows,) + (None,) * (len(spec.shape) - 1)
    return out


def _dp_rank(mesh, axes) -> int:
    """This process's index along ``axes`` (row-major, as the reference's
    tuple sharding orders devices)."""
    rank = 0
    for a in axes:
        rank = rank * mesh_axis_size(mesh, a) + mesh.get_local_rank(a)
    return rank


def shard_batch(batch: dict, specs: Dict[str, tuple], mesh) -> dict:
    """This process's rows of each input whose first dim is sharded over the
    data-parallel axes; the whole input where its spec replicates it."""
    out = {}
    for name, x in batch.items():
        spec = specs.get(name, ())
        axes = spec[0] if spec else None
        if axes is None:
            out[name] = x
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        n = mesh_axis_size(mesh, axes)
        rows = x.shape[0] // n
        i = _dp_rank(mesh, axes)
        out[name] = x[i * rows:(i + 1) * rows]
    return out


def default_optimizer(total_steps: int = 10000) -> Optimizer:
    return adamw(cosine_warmup(3e-4, 200, total_steps), wd=0.1)


def build_train_step(
    model,
    mesh,
    shape: ShapeSpec,
    optimizer: Optional[Optimizer] = None,
    step_cfg: Optional[IplsStepConfig] = None,
    extra_rules: Optional[dict] = None,
) -> BuiltStep:
    """The IPLS train step of ``model`` on ``mesh`` for a train ``shape``.
    Its ``fn`` updates the state's params (the model's own tensors when the
    state holds ``model.params()``) and optimizer state in place."""
    cfg = model.cfg
    optimizer = optimizer or default_optimizer()
    num_agents = 1
    for a in dp_axes(mesh):
        num_agents *= mesh_axis_size(mesh, a)
    step_cfg = step_cfg or IplsStepConfig()
    rules = dict(DEFAULT_RULES, **make_rules(mesh, "train"))
    rules.update(cfg.sharding_overrides)
    rules.update(extra_rules or {})

    specs = input_specs(cfg, shape)
    if "positions3" in specs or "enc_embeds" in specs:
        raise NotImplementedError(
            f"{cfg.name}: training M-RoPE and encoder-decoder models through the step builder is "
            "not ported yet (ROADMAP.md queue 1)")
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
    update_sh = tree_shardings(model.axes(), model.param_shapes(), mesh, rules, "data")
    raw_step = make_train_step(
        loss_fn, optimizer, step_cfg, num_agents=num_agents, update_shardings=update_sh,
        mesh=mesh,
    )

    def train_step(state, batch):
        local = shard_batch(batch, batch_sh, mesh)
        with activation_sharding(mesh, rules):
            return raw_step(state, local)

    return BuiltStep(fn=train_step, mesh=mesh, rules=rules, update_shardings=update_sh,
                     optimizer=optimizer)


def build_step(model, mesh, shape: ShapeSpec, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(model, mesh, shape, **kw)
    raise NotImplementedError(
        f"the {shape.kind} step builder is not ported yet (ROADMAP.md queue 1); "
        "serve through repro_torch.serve_lm"
    )
