"""The port's prefill and decode step builders (``launch/steps.py``) against
the JAX package's, and the decode step as one CUDA-graph replay.

- Specs: ``_batch_shardings`` (positions3 on dim 1), the parameters' and
  the cache's layouts and the logits' specs of the built prefill and
  decode steps at a fake (16, 16) and (2, 16, 16) mesh, equal to the
  reference's builders' on an ``AbstractMesh`` (per layer: the reference's
  stacked ``layers`` axis removed); ``shard_batch`` slices the dim the
  spec splits.
- Logits: the port's built steps on ``make_smoke_mesh("cpu")`` against the
  reference's built steps (jitted) on an Auto-axis (1, 1) mesh, for every
  arch of ``ARCH_IDS`` at its reduced width (``torch_serve_steps_ref``
  says how and within what; the archs of ``ARCHS`` here, the others in
  ``test_torch_serve_steps_families.py``).
- ``generate``: graph and eager give the same tokens and logits on the
  CPU (where both run eagerly) and, marked ``cuda``, on the card, where
  the graph's replays, its counted ``decode_attention`` launches and the
  bits of every step's logits are held to the eager loop's.

JAX is imported inside the tests that compare with it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm
from repro_torch.configs import ARCH_IDS, SHAPES, build_model, get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.launch import steps as psteps
from repro_torch.launch.mesh import make_rules, make_smoke_mesh
from repro_torch.models.convert import load_jax_cache
from repro_torch.models.whisper import WhisperModel
from torch_serve_steps_ref import B, CL, IMAGE, S, STEPS, check_built_steps, inputs

# the reference comparison of the built steps, per arch: these here, the
# others in test_torch_serve_steps_families.py (each file under 30 s alone)
ARCHS = ("gemma3-1b", "minitron-4b", "phi4-mini-3.8b", "internlm2-1.8b", "qwen2-vl-72b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pmesh():
    """The port's smoke mesh on the CPU (a one-process gloo group),
    destroyed after the module."""
    yield make_smoke_mesh("cpu")
    torch.distributed.destroy_process_group()


class _Names:
    """A mesh's axis names and sizes, without processes (what the builders'
    spec functions read), and this process's index on each axis."""

    def __init__(self, names, shape, ranks=None):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)
        self.ranks = ranks or {}

    def get_local_rank(self, axis):
        return self.ranks.get(axis, 0)


def _spec(sharding) -> tuple:
    return tuple(sharding.spec)


def _ref_specs(tree):
    import jax

    return jax.tree.map(_spec, tree)


def _per_layer(ref, n):
    """A reference spec tree whose leaves carry the stacked ``layers`` axis
    first (always unsharded): the port's per-layer list of it."""
    import jax

    def drop(s):
        assert s[:1] in ((), (None,)), s
        return s[1:]

    return [jax.tree.map(drop, ref, is_leaf=lambda x: isinstance(x, tuple))] * n


def _port_layout(ref: dict, model) -> dict:
    """The reference's param or cache spec tree in the port's layout."""
    out = {}
    for k, v in ref.items():
        if isinstance(model, WhisperModel) and k in ("enc", "dec"):
            out[k] = _per_layer(v, getattr(model.cfg, f"{k}_layers"))
        elif not isinstance(model, WhisperModel) and k.startswith("g") and \
                not k.endswith("_shared"):
            out[k] = _per_layer(v, model.cfg.groups[int(k[1:])].repeat)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("names,shape", [(("data", "model"), (16, 16)),
                                         (("pod", "data", "model"), (2, 16, 16))],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_specs_match_reference(arch, names, shape):
    """The built prefill and decode steps' specs (parameters, inputs, cache,
    logits) at production mesh shapes, for each serving shape of the
    registry: the reference's builders' on an AbstractMesh, per layer; and
    the train step's inputs, metrics and rules. Nothing is allocated but
    the reduced model's weights."""
    from jax.sharding import AbstractMesh
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from repro.launch import steps as jsteps

    model = build_model(get_config(arch, reduced=True), device="cpu")
    jmodel = jax_build(jax_config(arch, reduced=True))
    fake, jmesh = _Names(names, shape), AbstractMesh(shape, names)
    for key in ("prefill_32k", "decode_32k", "long_500k"):
        sh = SHAPES[key]
        got = psteps.build_step(model, fake, sh)
        want = jsteps.build_step(jmodel, jmesh, sh)
        assert got.rules == want.rules, key
        ins, outs = _ref_specs(want.in_shardings), _ref_specs(want.out_shardings)
        assert got.in_shardings[0] == _port_layout(ins[0], model), key
        assert got.in_shardings[-1] == ins[-1], key  # the batch
        assert got.out_shardings[0] == outs[0], key  # the logits
        cache = _port_layout(outs[1], model)
        if isinstance(model, WhisperModel):
            assert got.out_shardings[1].pop("enc_last") == ()
        assert got.out_shardings[1] == cache, key
        if sh.kind == "decode":
            assert got.in_shardings[1] == got.out_shardings[1]
        # arg_shapes: the parameters and the inputs (decode: the cache too)
        specs = got.arg_shapes[-1]
        assert {k: (v.shape, str(v.dtype)[6:]) for k, v in specs.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.arg_shapes[-1].items()}, key
    if isinstance(model, WhisperModel):  # whisper's training raises (ROADMAP.md queue 1)
        return
    # the train step (on a "model" axis of 1: tensor parallelism is not
    # ported): its inputs' specs, its metrics' and its rules
    sh, tshape = SHAPES["train_4k"], shape[:-1] + (1,)
    got = psteps.build_step(model, _Names(names, tshape), sh)
    want = jsteps.build_step(jmodel, AbstractMesh(tshape, names), sh)
    assert got.rules == want.rules
    assert got.in_shardings[1] == _ref_specs(want.in_shardings[1])
    assert got.out_shardings[1] == _ref_specs(want.out_shardings[1])
    assert got.arg_shapes[1].keys() == want.arg_shapes[1].keys()


def test_batch_shardings_match_reference():
    """positions3 on dim 1, whisper's frames and the tokens on dim 0, pos
    replicated, each batch split only where it divides the axes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from repro.launch import steps as jsteps

    for names, shape in ((("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16))):
        fake, jmesh = _Names(names, shape), AbstractMesh(shape, names)
        rules = make_rules(fake, "prefill")
        for b in (1, 8, 32, 64):
            specs = {"tokens": (b, 16), "token": (b, 1), "participation": (b,),
                     "positions3": (3, b, 16), "enc_embeds": (b, 16, 8), "pos": ()}
            jspecs = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in specs.items()}
            pspecs = {k: _Shape(v) for k, v in specs.items()}
            want = {k: _spec(v) for k, v in jsteps._batch_shardings(jspecs, jmesh, rules).items()}
            assert psteps._batch_shardings(pspecs, fake, rules) == want, (shape, b)


class _Shape:
    def __init__(self, shape):
        self.shape = shape


def test_shard_batch_splits_positions3_on_dim_1():
    """On a data axis of 2, rank 1 takes the second half of the batch: dim
    0 of the tokens and the frames, dim 1 of positions3; pos whole."""
    fake = _Names(("data", "model"), (2, 1), ranks={"data": 1})
    rules = {"batch": "data"}
    batch = {"tokens": torch.arange(4 * 6).reshape(4, 6),
             "positions3": torch.arange(3 * 4 * 6).reshape(3, 4, 6),
             "enc_embeds": torch.arange(4 * 6 * 2).reshape(4, 6, 2), "pos": torch.tensor(5),
             "cache_len": 9}
    specs = psteps._batch_shardings({k: _Shape(tuple(v.shape)) for k, v in batch.items()
                                     if k != "cache_len"}, fake, rules)
    assert specs["positions3"] == (None, "data", None) and specs["pos"] == ()
    local = psteps.shard_batch(batch, specs, fake)
    assert torch.equal(local["tokens"], batch["tokens"][2:])
    assert torch.equal(local["enc_embeds"], batch["enc_embeds"][2:])
    assert torch.equal(local["positions3"], batch["positions3"][:, 2:])
    assert local["pos"] is batch["pos"] and local["cache_len"] == 9
    with pytest.raises(ValueError, match="more than one dim"):
        psteps.shard_batch({"x": batch["positions3"]}, {"x": ("data", "data", None)}, fake)


@pytest.mark.parametrize("arch", ARCHS)
def test_built_steps_match_reference(arch, pmesh):
    """The built steps against the reference's (``torch_serve_steps_ref``)."""
    check_built_steps(arch, pmesh)


def test_load_jax_cache_rejects_a_foreign_cache(pmesh):
    model = build_model(get_config("internlm2-1.8b", reduced=True), device="cpu")
    with pytest.raises(KeyError):
        load_jax_cache(model, {"g0": {"b0": {"latent": np.zeros((2, 1, 4, 8), np.float32)}}})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_generate_graph_and_eager_agree_on_cpu(arch):
    """On the CPU a graph step runs eagerly: ``graph`` changes nothing, and
    the kept logits are the step-by-step decode's."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cpu", seed=1)
    prompt = serve_lm.prompt_tokens(cfg.vocab, B, S, 1)
    extra = serve_lm.request_inputs(cfg, B, S, 1, image=IMAGE)
    runs = [serve_lm.generate(model, prompt, 5, graph=g, keep_logits=True, **extra)
            for g in (True, False)]
    for r in runs:
        assert r["graph_replays"] == 0 and r["capture_s"] == 0.0 and r["graph_launches"] == {}
        assert r["step_logits"].shape == (4, B, 1, cfg.vocab)
        assert torch.equal(r["first_step_logits"], r["step_logits"][0])
    assert torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    assert torch.equal(runs[0]["step_logits"], runs[1]["step_logits"])
    # the tokens are each step's greedy choice
    assert torch.equal(runs[0]["tokens"][:, 1:],
                       runs[0]["step_logits"][:, :, 0].argmax(-1).t().int())


def test_decode_graph_steps_equal_decode_step():
    """``DecodeGraph`` without ``after`` is the model's decode step on its
    buffers; ``set_inputs`` takes an int or a tensor pos."""
    cfg = get_config("gemma3-1b", reduced=True)
    model = build_model(cfg, device="cpu", seed=2)
    toks, steps, _ = inputs(cfg, 2, "bfloat16")
    _, c1 = model.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
    _, c2 = model.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
    g = psteps.DecodeGraph(model, c1, torch.from_numpy(steps[0]), S)
    for i, tok in enumerate(steps):
        if i:
            g.set_inputs(torch.from_numpy(tok), torch.tensor(S + i, dtype=torch.int32))
        got = g.step()
        want, _ = model.decode_step(c2, {"token": torch.from_numpy(tok), "pos": S + i})
        assert torch.equal(got, want)
    assert g.replays == 0 and g.launches == {}
    g.close()


def test_dropped_built_steps_free_the_model(pmesh):
    """A built step and its decode graph hold the model, but nothing holds
    them back: with the cyclic collector off, dropping the steps, the cache
    and the model frees the model (no reference cycle through ``fn``)."""
    import gc
    import weakref

    cfg = get_config("internlm2-1.8b", reduced=True)
    model = build_model(cfg, device="cpu", seed=5)
    alive = weakref.ref(model)
    toks, steps, _ = inputs(cfg, 5, "bfloat16")
    gc.disable()
    try:
        pre = psteps.build_prefill_step(model, pmesh, ShapeSpec("p", S, B, "prefill"))
        dec = psteps.build_decode_step(model, pmesh, ShapeSpec("d", CL, B, "decode"), graph=True)
        _, cache = pre.fn({"tokens": torch.from_numpy(toks), "cache_len": CL})
        dec.fn(cache, {"token": torch.from_numpy(steps[0]), "pos": S})
        assert dec.decode_graph is not None and dec.decode_graph.model is model
        del pre, dec, cache, model
        assert alive() is None
    finally:
        gc.enable()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_generate_graph_equals_eager_on_cuda(arch):
    """On the card: every decode step after the first one replay, the same
    tokens and bitwise the same logits as the eager loop, and
    ``decode_attention`` counted exactly through the replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cuda", seed=3)
    n = 9
    prompt = serve_lm.prompt_tokens(cfg.vocab, B, S, 3)
    extra = serve_lm.request_inputs(cfg, B, S, 3, image=IMAGE, device=model.device)
    per_step = model.kernel_launches()["decode_step"]["decode_attention"]
    runs = []
    for g in (True, False):
        d0 = dops.decode.LAUNCHES
        runs.append(serve_lm.generate(model, prompt, n, graph=g, keep_logits=True, **extra))
        assert dops.decode.LAUNCHES - d0 == per_step * (n - 1), g
    graph, eager = runs
    assert graph["graph_replays"] == n - 2 and eager["graph_replays"] == 0
    assert graph["graph_launches"].get(dops.decode, 0) == per_step
    assert torch.equal(graph["tokens"], eager["tokens"])
    assert torch.equal(graph["step_logits"].view(torch.int16),
                       eager["step_logits"].view(torch.int16))


@pytest.mark.cuda
def test_built_decode_graph_equals_eager_on_cuda():
    """The built decode step with ``graph`` on the CUDA smoke mesh: the
    same bits as without, and one replay a call after the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    cfg = get_config("internlm2-1.8b", reduced=True)
    model = build_model(cfg, device="cuda", seed=4)
    mesh = make_smoke_mesh("cuda")
    try:
        toks, steps, _ = inputs(cfg, 4, "bfloat16")
        pre = psteps.build_prefill_step(model, mesh, ShapeSpec("p", S, B, "prefill"))
        outs = []
        for graph in (True, False):
            dec = psteps.build_decode_step(model, mesh, ShapeSpec("d", CL, B, "decode"),
                                           graph=graph)
            _, cache = pre.fn({"tokens": torch.from_numpy(toks), "cache_len": CL})
            pos = torch.tensor(S, dtype=torch.int32, device=model.device)
            seq = []
            for tok in steps:
                logits, cache = dec.fn(cache, {"token": torch.from_numpy(tok).cuda(), "pos": pos})
                seq.append(logits.clone())
                pos += 1
            outs.append(torch.stack(seq))
            if graph:
                assert dec.decode_graph.replays == STEPS - 1
                dec.decode_graph.close()
        assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))
    finally:
        torch.distributed.destroy_process_group()
