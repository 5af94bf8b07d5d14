"""MoE experts over a "model" mesh axis above 1 (the reference's
``_apply_moe_shardmap``: expert-parallel, ffn-parallel and replicated) on
gloo meshes of CPU processes, granite-moe-reduced in float32, one spawn of
``tests/torch_tp_moe_worker.py`` per mesh:

* (1, 2): ffn-parallel (granite's overrides: each rank a half of every
  expert's hidden dim) and expert-parallel (no overrides: 4 of the 8
  experts a rank, the router's columns split and gathered before routing);
* (2, 2): ffn-parallel with two data ranks (capacity and load-balance loss
  per data rank);
* (1, 3): replicated (neither 8 experts nor 32 hidden divide 3): no sum,
  each rank its rows of the whole block.

Each mesh holds a train step, a prefill and 8 decode steps to the
model-axis-1 mesh path in one process, the router's gradient apart (the
worker's docstring gives each bound); the meshes with one data rank also
hold the lossless copy (``test_torch_moe_lm.lossless``) to the reference
on one device with the MoE family's bounds: the loss within 1e-5, the
gradients within 5e-3 of each leaf's largest, the logits within one bf16
ulp + 1e-5. Also, in one process: the rank partials of each mode summed in
rank order equal the model-axis-1 layer (``moe_rank_partial``, the
function the card's ``moe_ep`` phase runs at full width).
"""
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers as L  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

import torch_tp_moe_worker as worker  # noqa: E402
from test_torch_tp import one_torch_thread  # noqa: E402,F401


def _reference():
    """The reference's lossless granite-reduced in float32: its params, one
    train step (SGD as the worker's, clip 1, one agent) with its gradients
    (the update over the learning rate) by name, a prefill's and 8 decode
    steps' logits."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from repro.core import sharded as jsh
    from repro.optim import sgd as jsgd
    from test_torch_moe_lm import lossless

    B, S, T, STEPS = worker.B, worker.S, worker.T, worker.STEPS
    model = jax_build(lossless(jax_config(worker.ARCH, reduced=True)))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), model.init(0))
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    step = jax.jit(jsh.make_train_step(model.loss, jsgd(worker.LR),
                                       jsh.IplsStepConfig(grad_clip=1.0), num_agents=1))
    state, m = step(jsh.init_state(params, jsgd(worker.LR)),
                    {"tokens": jnp.asarray(tokens), "participation": jnp.ones((B,), jnp.float32)})
    before = dict(named_leaves(jax.tree.map(np.asarray, params)))
    after = dict(named_leaves(jax.tree.map(np.asarray, state.params)))
    serve_tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    steps = rng.integers(0, 256, (STEPS, B, 1)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "cache_len": T}))(
        params, jnp.asarray(serve_tokens))
    decode = jax.jit(model.decode_step)
    dec = []
    for t in range(STEPS):
        lg, cache = decode(params, cache, {"token": jnp.asarray(steps[t]),
                                           "pos": jnp.asarray(S + t, jnp.int32)})
        dec.append(np.asarray(lg.astype(jnp.float32)))
    return {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
            "loss": float(m["loss"]),
            "grads": {k: (before[k] - after[k]) / np.float32(worker.LR) for k in after},
            "serve_tokens": serve_tokens, "steps": steps,
            "prefill_logits": np.asarray(logits.astype(jnp.float32)),
            "decode_logits": np.stack(dec)}


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_moe_ref") / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump(_reference(), f)
    return str(path)


def _spawn(shape, tmp_path, ref_path):
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    mp.start_processes(worker.run, args=(world, shape, str(tmp_path), ref_path), nprocs=world,
                       join=True, start_method="spawn")
    gaps = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    print(f"mesh {shape}: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    return worst


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 3)],
                         ids=["1x2-ffn-and-expert", "2x2-ffn", "1x3-replicated"])
def test_moe_model_axis_equals_one_process_and_reference(shape, tmp_path, reference_pickle):
    worst = _spawn(shape, tmp_path, reference_pickle)
    for mode in worker.CASES[shape]:
        assert worst[f"{mode}/router_split"] == (mode == "expert")
        assert f"{mode}/router_grad_vs_float64" in worst
        assert f"{mode}/decode_logits" in worst
        if shape[0] == 1:
            assert worst[f"{mode}/ref_loss_rel"] <= 1e-5
            assert worst[f"{mode}/ref_grads"] <= worker.REF_GRAD_TOL
            assert worst[f"{mode}/ref_router_grads"] <= worker.REF_GRAD_TOL
            assert worst[f"{mode}/ref_prefill_logits_ulps"] <= 1.0
            assert worst[f"{mode}/ref_decode_logits_ulps"] <= 1.0


def _slices(p, mode, r, M):
    """Rank r's weight slices for a mode (the shared experts' hidden dim
    split as the default rules split "ffn")."""
    out = dict(p)
    if mode == "expert":
        n = p["wg"].shape[0] // M
        out.update({k: p[k][r * n:(r + 1) * n] for k in ("wg", "wu", "wd")})
    elif mode == "ffn":
        n = p["wg"].shape[2] // M
        out.update(wg=p["wg"][:, :, r * n:(r + 1) * n], wu=p["wu"][:, :, r * n:(r + 1) * n],
                   wd=p["wd"][:, r * n:(r + 1) * n])
    if "shared" in p:
        n = p["shared"]["wu"].shape[1] // M
        sh = p["shared"]
        out["shared"] = {"wg": sh["wg"][:, r * n:(r + 1) * n], "wu": sh["wu"][:, r * n:(r + 1) * n],
                         "wd": sh["wd"][r * n:(r + 1) * n]}
    return out


@pytest.mark.parametrize("mode", ["expert", "ffn", "replicated"])
def test_rank_partials_sum_to_the_layer(mode):
    """deepseek-like routed and shared experts (8 experts top-2, 2 shared),
    float32, over a model axis of 4: each rank's part from its slices,
    summed in rank order, within 1e-5 of the model-axis-1 layer (routed +
    shared), the same choices on every rank; the load-balance loss the
    same on every rank and equal to the layer's."""
    s = L.MoESpec(d_model=64, d_expert=32, num_experts=8, top_k=2, num_shared=2, d_shared=64,
                  capacity_factor=1.25)
    rng = np.random.default_rng(3)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32))

    p = {"router": draw(64, 8), "wg": draw(8, 64, 32), "wu": draw(8, 64, 32),
         "wd": draw(8, 32, 64), "shared": {"wg": draw(64, 64), "wu": draw(64, 64),
                                           "wd": draw(64, 64)}}
    x = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32))

    class _OneRank:
        mesh_dim_names, shape = ("data", "model"), (1, 1)

    want, lb = L._apply_moe_mesh(p, s, x, (_OneRank(), {"batch": "data"}))
    want = want + L.apply_mlp(p["shared"], L.MLPSpec(64, 64), x)
    C, M = L.moe_capacity(s, 32), 4
    total, choices = torch.zeros_like(want), []
    for r in range(M):
        part, lb_r, top_i = L.moe_rank_partial(_slices(p, mode, r, M), s, x, C, mode, r, M)
        total += part
        choices.append(top_i)
        assert torch.equal(lb_r, lb)
    assert all(torch.equal(c, choices[0]) for c in choices)
    gap = float((total - want).abs().max())
    print(f"{mode}: the rank partials' sum vs the layer {gap:.3g}")
    assert gap <= 1e-5
