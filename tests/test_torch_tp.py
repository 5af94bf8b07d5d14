"""Tensor parallelism (a "model" mesh axis above 1) of the dense LMs on gloo
meshes of CPU processes: internlm2-reduced and phi4-mini-reduced (tied
embeddings) in float32 on (data, model) = (1, 2), (2, 2), (1, 4) and
(1, 3), one spawn of worker processes (``tests/torch_tp_worker.py``) per
mesh, meeting through a file store in the test's tmp_path.

* (1, 2), (2, 2): heads, kv heads, ffn and vocab split (head-parallel
  attention, column- then row-parallel MLP, vocab-parallel embedding,
  logits and cross entropy);
* (1, 3): heads, ffn and vocab do not divide: sequence-parallel attention
  (the query rows at their offset, k and v gathered), the MLP and the CE
  on the rank's rows.

Each mesh holds the init, one train step (AdamW, clipping, two
microbatches; on (2, 2) also with a data rank's agents dropped), a prefill
and 8 decode steps to the port in one process (the worker's docstring
gives each bound and why: 1e-5 of max(1, |value|) in float32 where the
ranks' reordered float32 sums allow it, else measured against the float32
noise of the one-process run itself). (1, 2) also carries the reference's
tree into the shards and back and checkpoints between the mesh and one
process. ``test_torch_tp_reference.py`` holds (1, 4) and (1, 3) to the
JAX reference.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.sharding_hooks import TP  # noqa: E402

import torch_tp_worker as worker  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The spawned workers set one thread each; the parent only waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(shape, tmp_path, ref_path=None, module=worker):
    """``module.run`` on a gloo mesh of ``shape``; the worst of the ranks'
    gaps by key."""
    world = shape[0] * shape[1]
    mp.start_processes(module.run, args=(world, shape, str(tmp_path), ref_path), nprocs=world,
                       join=True, start_method="spawn")
    gaps = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(world)]
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    print(f"mesh {shape}: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    return worst


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 3)],
                         ids=["1x2", "2x2", "1x3-sequence-parallel"])
def test_tp_mesh_equals_one_process(shape, tmp_path):
    worst = _spawn(shape, tmp_path)
    for arch in worker.ARCHS:
        assert worst[f"{arch}/train/metric_loss"] <= worker.TOL
        n_split = worst[f"{arch}/init_split_leaves"]
        # (1, 3) splits no leaf; on a model axis of 2 heads, kv heads, ffn and
        # vocab all split: every matrix leaf of the two layers and the tables
        assert n_split == 0 if shape == (1, 3) else n_split >= 7 * 2 + 1
    if shape == (2, 2):
        assert "internlm2-1.8b/train_drop/metric_participation" in worst
    if shape == (1, 2):
        assert all(worst[f"{a}/checkpoint_bitwise"] == 1 for a in worker.ARCHS)




@pytest.mark.parametrize("H,KV,M", [(4, 2, 2), (4, 2, 4), (8, 2, 4), (6, 2, 3), (12, 4, 3)])
def test_head_parallel_attention_sums_to_one_process(H, KV, M):
    """Each rank's head-parallel training attention (its query heads; its kv
    heads where the axis divides them, else the ones its heads read from
    the whole weights: one a rank at (4, 2, 4) and (8, 2, 4), an index
    where its heads straddle two groups at (6, 2, 3) and (12, 4, 3)) sums
    over the ranks to the one-process attention, in float32 within 1e-5.
    One process: the layer itself makes no collective (the block around it
    gathers and reduce-scatters)."""
    d, hd, B, S = 32, 8, 2, 6
    rng = np.random.default_rng(H * 100 + KV * 10 + M)
    s = L.AttnSpec(d_model=d, n_heads=H, kv_heads=KV, head_dim=hd)
    shapes = {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd), "wo": (H, hd, d)}
    p = {k: torch.from_numpy((rng.standard_normal(v) / np.sqrt(v[0])).astype(np.float32))
         for k, v in shapes.items()}
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    want = L.apply_attention(p, s, x, pos)
    Hl, kv_split = H // M, KV % M == 0
    got = torch.zeros_like(want)
    for r in range(M):
        local = {"wq": p["wq"][:, r * Hl:(r + 1) * Hl], "wo": p["wo"][r * Hl:(r + 1) * Hl]}
        for key in ("wk", "wv"):
            local[key] = p[key][:, r * (KV // M):(r + 1) * (KV // M)] if kv_split else p[key]
        got += L._apply_attention_tp(local, s, x, pos, TP(None, M, r))
    gap = float((got - want).abs().max())
    print(f"H={H} KV={KV} M={M}: sum over ranks vs one process {gap:.3g}")
    assert gap <= 1e-5


class _Mesh:
    """A mesh's names and shape, no processes: what the builders read
    before a step runs."""

    def __init__(self, shape):
        self.mesh_dim_names, self.shape = ("data", "model"), shape


def test_unported_tensor_parallel_modes_raise():
    """On a model axis above 1 what is not ported raises: a decode graph
    (NotImplementedError). What this test refused before now builds or
    runs: whisper holds its rank's shards (heads, ffn and vocab split over
    2), non-causal attention (an encoder's) builds in a decoder-only
    config, and a sequence that does not split over the axis is whole on
    every rank in the decoder-only families too (``_tp_ctx``: no rows, the
    "local" positions all of them, as the reference's specs leave it; the
    mesh paths: ``test_torch_tp_whole*.py``); every family's shards are the
    reference's specs (``test_torch_tp*.py``, ``test_torch_tp_whisper.py``).
    A step of a model not built on the mesh raises ValueError before it
    runs."""
    import dataclasses

    from repro_torch.configs import SHAPES, build_model, get_config
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.transformer import _tp_ctx
    from repro_torch.models.sharding_hooks import activation_sharding
    from repro_torch.roofline import fake_world

    cfg = get_config("internlm2-1.8b", reduced=True)
    encoder = dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, blocks=tuple(
            dataclasses.replace(b, attn=dataclasses.replace(b.attn, causal=False))
            if b.kind == "attn" else b for b in g.blocks)) for g in cfg.groups))
    with fake_world((1, 2)) as fmesh:
        whisper = build_model(get_config("whisper-base", reduced=True), device="cpu", mesh=fmesh)
        assert whisper.mesh is fmesh
        assert whisper.params()["dec"][0]["self_attn"]["wq"].shape == (64, 2, 16)
        assert whisper.params()["enc"][0]["mlp"]["wd"].shape == (64, 64)
        assert whisper.params()["embed"]["table"].shape == (128, 64)
        assert build_model(encoder, device="cpu", mesh=fmesh).mesh is fmesh
        positions = torch.arange(9)[None]
        with activation_sharding(fmesh):
            ctx = _tp_ctx({"positions": positions}, 9)
            assert ctx["rows"] is None and ctx["positions_local"].shape == (1, 9)
            assert _tp_ctx({"positions": positions[:, :8]}, 8)["rows"] == slice(0, 4)
    mesh = _Mesh((1, 2))
    model = build_model(get_config("internlm2-1.8b", reduced=True), device="cpu")
    with pytest.raises(NotImplementedError, match="decode graph"):
        build_decode_step(model, mesh, SHAPES["decode_32k"], graph=True)
    built = build_prefill_step(model, mesh, SHAPES["prefill_32k"])  # specs only
    with pytest.raises(ValueError, match="built on that mesh"):
        built.fn({"tokens": torch.zeros((32, 8), dtype=torch.int32)})
