"""FSDP (``IplsStepConfig(fsdp=True)``: parameters stored as each rank's
"data" shard, gathered per layer inside its checkpoint, gradients
reduce-scattered by the gather's backward) on gloo meshes of CPU
processes, one spawn of ``tests/torch_fsdp_worker.py`` per mesh:

* (2, 1): internlm2-reduced, deepseek-v2-lite-reduced (MoE on the mesh
  path), whisper-reduced (tied table used twice) and zamba2-reduced
  (shared blocks gathered in every period); internlm2 also with a data
  rank's agents dropped, and an fsdp checkpoint round trip;
* (2, 2): internlm2-reduced with tensor parallelism, the "data" shard
  inside each "model" shard.

The worker's docstring gives each check. Bounds: the stored shard 1/2 of
every split leaf; against the step without fsdp on the same mesh bit for
bit where the sums keep their order (internlm2 and deepseek on (2, 1));
against the one-process step without fsdp within 1e-5 of max(1, |v|) at
one microbatch, and internlm2 at two (of its float64 step, or four times the float32
step's own gap to it where that is larger: whisper-reduced's params lie
1.7e-4 apart between two float32 summation orders); against the
reference's one-device step (internlm2, carried in as ``test_torch_tp_reference.py`` does) the loss
within 1e-5 relative and parameters and gradients within 2e-3 of each
leaf's largest.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fsdp_worker as worker  # noqa: E402
from test_torch_tp import one_torch_thread  # noqa: E402,F401
from repro_torch.tree import named_leaves  # noqa: E402


def _reference():
    """The reference's float32 params of internlm2-reduced and its one-device
    step (SGD as the worker's, clip 1, num_agents = 2 as the meshes' data
    axis) on the worker's batch: loss, params after and gradients (the
    update over the learning rate), by name."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from repro.core import sharded as jsh
    from repro.optim import sgd as jsgd

    model = jax_build(jax_config(worker.REF_ARCH, reduced=True))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), model.init(0))
    tokens = np.random.default_rng(1).integers(0, 256, (worker.B, worker.S)).astype(np.int32)
    step = jax.jit(jsh.make_train_step(model.loss, jsgd(worker.LR),
                                       jsh.IplsStepConfig(grad_clip=worker.CLIP), num_agents=2))
    state, m = step(jsh.init_state(params, jsgd(worker.LR)),
                    {"tokens": jnp.asarray(tokens),
                     "participation": jnp.ones((worker.B,), jnp.float32)})
    before = dict(named_leaves(jax.tree.map(np.asarray, params)))
    after = dict(named_leaves(jax.tree.map(np.asarray, state.params)))
    return {"params": jax.tree.map(np.asarray, params), "loss": float(m["loss"]),
            "params_after": after,
            "grads": {k: (before[k] - after[k]) / np.float32(worker.LR) for k in after}}


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("fsdp_ref") / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump(_reference(), f)
    return str(path)


def _spawn(shape, tmp_path, ref_path=None):
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    mp.start_processes(worker.run, args=(world, shape, str(tmp_path), ref_path), nprocs=world,
                       join=True, start_method="spawn")
    import json

    gaps = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    print(f"mesh {shape}: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    return worst, gaps


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2-tensor-parallel"])
def test_fsdp_mesh_equals_one_process_and_reference(shape, tmp_path, reference_pickle):
    worst, gaps = _spawn(shape, tmp_path, reference_pickle)
    for arch in worker.ARCHS[shape]:
        # every leaf with a dim that 2 divides is stored split
        assert worst[f"{arch}/stored_split_leaves"] >= worst[f"{arch}/leaves"] // 2
        assert worst[f"{arch}/vs_no_fsdp"] <= worker.TOL
        for a in (1, 2) if arch == worker.REF_ARCH else (1,):
            key = f"{arch}/one_a{a}_params"
            assert worst[f"{key}_vs_float64"] <= max(worker.TOL,
                                                      worker.NOISE * worst[f"{key}_noise"])
    assert worst["ref_loss_rel"] <= 1e-5
    assert worst["ref_params"] <= worker.REF_TOL and worst["ref_grads"] <= worker.REF_TOL
    if shape == (2, 1):
        # untied, no shared blocks: the gradients' sums keep their order
        assert all(min(g[f"{a}/bitwise_vs_no_fsdp"] for g in gaps) == 1
                   for a in ("internlm2-1.8b", "deepseek-v2-lite-16b"))
        assert worst["internlm2-1.8b/drop_a1_params_vs_float64"] <= worker.TOL
        assert worst["checkpoint_bitwise"] == 1


def test_train_overrides_equal_the_reference():
    """The port's per-arch train overrides are the reference's, and each
    builds an ``IplsStepConfig``: fsdp for deepseek-v2-lite-16b and
    qwen2-vl-72b."""
    pytest.importorskip("jax")
    from repro.launch.steps import TRAIN_OVERRIDES as REF
    from repro_torch.core.sharded import IplsStepConfig
    from repro_torch.launch.steps import TRAIN_OVERRIDES

    assert TRAIN_OVERRIDES == REF
    assert all(IplsStepConfig(**kw).fsdp for kw in TRAIN_OVERRIDES.values())
