"""long_500k's layout on a mesh: the long-context decode (past 100,000 cache
slots, ``kv_seq`` over ("data", "model")) of gemma3-, zamba2- and
rwkv6-reduced on gloo meshes (data, model) = (2, 1), (1, 2) and (2, 2) of
CPU processes, at 131,072 slots (``tests/torch_long_cp_worker.py``; its
docstring gives every bound), against the port in one process and the JAX
reference on the same weights and cache; and a prefill built at that
shape, its caches in that layout, against one process.

The context-parallel group is the data x model ranks: rank (d, m) holds
slots [(d M + m) T, (d M + m + 1) T) of each full cache and ring, each rank
decodes the partial form over its slots, and the partials merge in rank
order. Before this layout, a mesh with a "data" axis above 1 and a "model"
axis of 1 handed each rank its declared share of the slots and decoded it
as the whole cache: the worker shows that arithmetic wrong on (2, 1) and
the step right. A decode graph on such a mesh raises (its collectives
would be captured).

The reference runs here, from numpy seeds (its cache drawn as
``test_torch_long_context.py`` draws it: keys and values std 1, states and
histories 0.1), and hands the workers a pickle: the cache, the tokens and
its logits at the worker's positions (float32; zamba2 also float64).
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, build_model, get_config  # noqa: E402
from repro_torch.configs.registry import ShapeSpec  # noqa: E402
from repro_torch.launch.steps import build_decode_step  # noqa: E402

import torch_long_cp_worker as worker  # noqa: E402
from test_torch_tp import _Mesh, _spawn, one_torch_thread  # noqa: E402,F401


def _reference(arch):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from test_torch_long_context import _seeded_cache
    from torch_serve_steps_ref import _ref_params

    model = worker.model_of(arch)
    jmodel = jax_build(jax_config(arch, reduced=True))
    params = _ref_params(model.params())
    cache = _seeded_cache(jmodel, seed=len(arch))
    rng = np.random.default_rng(7)
    tokens = [rng.integers(0, model.cfg.vocab, (1, 1), dtype=np.int32) for _ in worker.POSITIONS]
    step = jax.jit(jmodel.decode_step)

    def logits(dtype):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        c = jax.tree.map(lambda a: jnp.asarray(a, dtype), cache)
        out = []
        for tok, pos in zip(tokens, worker.POSITIONS):
            lg, c = step(p, c, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32)})
            out.append(np.asarray(lg, np.float64)[:, 0])
        return np.stack(out)

    out = {"cache": cache, "tokens": tokens, "logits32": logits(jnp.float32)}
    if arch in worker.F64_WITNESSED:
        with jax.enable_x64(True):
            out["logits64"] = logits(jnp.float64)
    return out


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("long_cp_ref") / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({a: _reference(a) for a in worker.ARCHS}, f)
    return str(path)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=["2x1", "1x2", "2x2"])
def test_long_decode_over_data_and_model_equals_one_process(shape, tmp_path,
                                                            reference_pickle):
    worst = _spawn(shape, tmp_path, reference_pickle, module=worker)
    for arch in worker.ARCHS:
        logits = ("logits_of_float64_bound" if arch in worker.F64_WITNESSED else "logits")
        assert f"{arch}/{logits}" in worst and f"{arch}/cache_vs_float64" in worst
        assert f"{arch}/prefill_{logits}" in worst
        assert f"{arch}/prefill_cache_vs_float64" in worst
        key = ("ref_logits_of_float64_bound" if arch in worker.F64_WITNESSED
               else "ref_logits_of_ulp_bound")
        assert worst[f"{arch}/{key}"] <= 1.0
        if shape == (2, 1):
            # the parent's layout decoded a later rank's slots as slots 0..
            want = 0 if arch == "rwkv6-7b" else 1  # rwkv6 keeps no slots
            assert worst[f"{arch}/parent_layout_wrong_at_pos100"] == want


def test_long_decode_graph_raises_with_a_data_axis():
    """``graph=True`` on a long-context mesh whose context-parallel group is
    above 1 raises, a "model" axis of 1 included (the merge's collectives
    would be captured into the graph); the step builds eagerly; at 100,000
    slots or fewer the rules put ``kv_seq`` on "model" alone and a (2, 1)
    mesh builds a graph."""
    model = build_model(get_config("gemma3-1b", reduced=True), device="cpu")
    mesh = _Mesh((2, 1))
    with pytest.raises(NotImplementedError, match="decode graph"):
        build_decode_step(model, mesh, SHAPES["long_500k"], graph=True)
    built = build_decode_step(model, mesh, SHAPES["long_500k"])
    assert built.rules["kv_seq"] == ("data", "model")
    short = build_decode_step(model, mesh, ShapeSpec("d", 1024, 2, "decode"), graph=True)
    assert short.rules["kv_seq"] == "model" and short.graph_slot is not None
