"""The attention variants over a "model" mesh axis above 1 on gloo meshes
of CPU processes: deepseek-reduced (MLA, with its MoE layers),
gemma3-reduced (sliding windows, qk-norm, the embedding scale, the tied
table) and qwen2-vl-reduced (M-RoPE with positions3 that are not the token
positions, qkv biases) in float32, one spawn of
``tests/torch_tp_attn_worker.py`` per mesh:

* (1, 2): every arch's 4 heads split over 2 (head-parallel attention and
  MLA, the block input gathered over the sequence); gemma3's 8-slot rings
  and the full caches split over the ranks' slots (context-parallel
  decode);
* (2, 2) (``test_torch_tp_attn_fsdp.py``): the same with two data ranks,
  fsdp for deepseek and qwen2-vl (the reference's ``TRAIN_OVERRIDES``);
* (1, 3): 4 heads do not divide 3: sequence-parallel attention and MLA (the
  query rows at their offset against the gathered keys, or latent and
  k_rope); gemma3-reduced's 8-slot rings do not split over 3: they stay
  whole beside its full caches split over the slots (a mixed layout, each
  layer decoding in its own), and the windowed layout over split rings
  runs on a copy with 6-slot windows.

Each mesh holds the init, one train step, a prefill and 8 decode steps to
the port in one process, with the dense tensor-parallel tests' bounds and
float32 noise rule (the
worker's docstring gives each; the test prints the measured gaps). Also, in
one process: the MLA decode's partials over M slices of the latent cache,
merged by log-sum-exp, equal ``decode_mla`` over the whole cache, and each
rank's head-parallel MLA sums to the layer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.sharding_hooks import TP  # noqa: E402

import torch_tp_attn_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401

MLA_MERGE_TOL = 2e-6  # float32: of the output's largest |value|


def check_mesh(shape, tmp_path):
    """One spawn of the worker on ``shape``, its cases' keys present."""
    worst = _spawn(shape, tmp_path, module=worker)
    for name in worker.CASES[shape]:
        assert f"{name}/decode_logits" in worst and f"{name}/decode_cache_vs_float64" in worst
        assert f"{name}/train/params_beyond_tol_over_lr" in worst
        # (1, 3) splits no leaf; over 2 ranks every head-split leaf does
        assert (worst[f"{name}/init_split_leaves"] == 0) == (shape == (1, 3))
    if shape == (1, 3):
        assert worst["gemma3-ring8/mixed_layout"] == 1
        assert "gemma3-ring8/decode_logits" in worst
        assert "gemma3-ring8/decode_cache_vs_float64" in worst
    if shape == (1, 2):
        assert worst["deepseek-v2-lite-16b/checkpoint_bitwise"] == 1
    return worst


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)],
                         ids=["1x2-head-parallel", "1x3-sequence-parallel"])
def test_attention_variants_on_a_mesh_equal_one_process(shape, tmp_path):
    check_mesh(shape, tmp_path)


def _mla(seed, B=2, T=24, d=32, H=4):
    s = L.MLASpec(d_model=d, n_heads=H, kv_lora=16, qk_nope=8, qk_rope=4, v_head=8)
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))

    p = {"wq": draw(d, H, 12), "wdkv": draw(d, 16), "wk_rope": draw(d, 4),
         "kv_norm": {"scale": draw(16)}, "wuk": draw(16, H, 8), "wuv": draw(16, H, 8),
         "wo": draw(H, 8, d)}
    cache = {"latent": torch.from_numpy(rng.standard_normal((B, T, 16)).astype(np.float32)),
             "k_rope": torch.from_numpy(rng.standard_normal((B, T, 4)).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((B, 1, d)).astype(np.float32))
    return s, p, cache, x


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("p", [5, 23], ids=["slices-without-keys", "every-slot"])
def test_mla_partials_merge_to_decode_mla(M, p):
    """The context-parallel MLA decode's arithmetic in one process: each of
    M slices of a 24-slot latent cache gives its float32 partial
    (``mla_partial``: 0 and -inf where no slot is at most pos, as the decode
    kernel's partial form), merged in rank order by
    ``decode_ops.merge_partials`` and projected per rank's heads, summed:
    within MLA_MERGE_TOL of the output's largest of ``decode_mla`` over the
    whole cache (the same token written at pos)."""
    s, params, cache, x = _mla(10 * M + p)
    pos = torch.tensor(p, dtype=torch.int32)
    whole = {k: v.clone() for k, v in cache.items()}
    want, _ = L.decode_mla(params, s, x, whole, pos)
    q_lat, q_rope, latent_new, k_rope_new = L.mla_decode_inputs(params, s, x, pos)
    cache["latent"][:, p] = latent_new[:, 0]
    cache["k_rope"][:, p] = k_rope_new[:, 0]
    assert torch.equal(cache["latent"], whole["latent"])
    Tl = 24 // M
    parts = [L.mla_partial(s, q_lat, q_rope, cache["latent"][:, r * Tl:(r + 1) * Tl],
                           cache["k_rope"][:, r * Tl:(r + 1) * Tl], pos, r * Tl)
             for r in range(M)]
    empty = [r for r in range(M) if r * Tl > p]
    for r in empty:
        o, lse = parts[r]
        assert torch.equal(o, torch.zeros_like(o)) and bool(torch.isneginf(lse).all())
    assert bool(empty) == (p == 5)
    merged = decode_ops.merge_partials(torch.stack([o for o, _ in parts]),
                                       torch.stack([lse for _, lse in parts]), x.dtype)
    Hl = s.n_heads // 2
    got = sum(L.mla_heads_out({"wuv": params["wuv"][:, h * Hl:(h + 1) * Hl],
                               "wo": params["wo"][h * Hl:(h + 1) * Hl]},
                              merged[:, None, h * Hl:(h + 1) * Hl]) for h in range(2))
    gap = float((got - want).abs().max()) / float(want.abs().max())
    print(f"M={M} pos={p}: merged MLA partials vs decode_mla {gap:.3g} of the largest")
    assert gap <= MLA_MERGE_TOL


@pytest.mark.parametrize("M", [2, 4])
def test_head_parallel_mla_sums_to_the_layer(M):
    """Each rank's head-parallel MLA (its heads of wq, wuk, wuv and wo; the
    latent's weights whole) over the whole sequence, summed over the ranks:
    the layer in one process within 1e-5 (float32). No collective: the
    block around it gathers and reduce-scatters."""
    s, p, _, _ = _mla(M)
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((2, 6, s.d_model)).astype(np.float32))
    pos = torch.arange(6)[None].expand(2, 6)
    want, latent, k_rope = L.prefill_mla(p, s, x, pos)
    Hl = s.n_heads // M
    got = torch.zeros_like(want)
    for r in range(M):
        local = dict(p, wq=p["wq"][:, r * Hl:(r + 1) * Hl], wuk=p["wuk"][:, r * Hl:(r + 1) * Hl],
                     wuv=p["wuv"][:, r * Hl:(r + 1) * Hl], wo=p["wo"][r * Hl:(r + 1) * Hl])
        y, lat, kr = L.prefill_mla(local, s, x, pos)
        assert torch.equal(lat, latent) and torch.equal(kr, k_rope)
        got += y
    gap = float((got - want).abs().max())
    print(f"M={M}: head-parallel MLA summed over ranks vs the layer {gap:.3g}")
    assert gap <= 1e-5


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_owned_slot(ring):
    """The token's slot in a cache of 3 x 4 slots split over 3 ranks: pos of
    a full cache, pos % 12 of a ring; one rank owns it (none past a full
    cache's end)."""
    for p in (0, 5, 11, 12, 17, 30):
        pos = torch.tensor(p, dtype=torch.int32)
        owners = []
        for r in range(3):
            slot, own = L._owned_slot(pos, 4, TP(None, 3, r), ring)
            if bool(own):
                owners.append(r)
                assert r * 4 + int(slot) == (p % 12 if ring else p)
        assert owners == ([] if not ring and p >= 12 else [(p % 12 if ring else p) // 4])
