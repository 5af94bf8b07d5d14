"""The recurrent families over a "model" mesh axis above 1 on gloo meshes of
CPU processes: zamba2-reduced (Mamba2 blocks, its shared attention and MLP
blocks) and rwkv6-reduced (RWKV6's time and channel mix) in float32, with
head-aligned and unaligned copies, one spawn of
``tests/torch_tp_ssm_worker.py`` per mesh:

* (1, 2): zamba2's in-projection split into columns that hold no whole
  head (gathered), its 2 heads one a rank; 8 heads of 16, 4 a rank; one
  head of 128 whole on every rank with ``w_out``'s rows split (a partial
  sum); rwkv6's one head of 64 split in halves (the leaves gathered, the
  block whole on every rank) and 4 heads of 16, 2 a rank (the scan on the
  rank's heads, the columns-to-rows all-to-all); two mutations of the
  mesh path (RWKV6's output reduce-scattered as a sum; Mamba2's ``w_in``
  gathered without its gradient's sum) fail the checks; zamba2's
  reference-layout tree and checkpoints between the mesh and one process,
  bit for bit;
* (1, 3): nothing splits over 3: every rank runs the blocks whole and
  keeps its rows;
* (2, 2) with fsdp (``test_torch_tp_ssm_fsdp.py``).

Each mesh holds the init, one train step (twice: with float32 logits by
the float32 noise rule alone, and with the bf16 logits the model ships,
the noise floored by the measured flips of the logits' bf16 gradient), a
prefill and 8 decode steps to the port in one process, with the dense
tensor-parallel tests' bounds and float32 noise rule (the workers'
docstrings give each; the test prints the measured gaps). In one process, without a spawn: each block's rank parts
(the functions the mesh path runs on each rank, their collectives outside
them), combined as the collectives combine them, equal the layer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import ssm as S  # noqa: E402

import torch_tp_ssm_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401

# float32 where the blocks compute in float32 (the norms, the gates, the
# scan's plain version): of the output's largest |value|
PARTS_TOL = 1e-5
PARTS_TOL_F64 = 1e-12  # where the arithmetic is float64 throughout


def check_mesh(shape, tmp_path):
    """One spawn of the worker on ``shape``, its cases' keys present."""
    worst = _spawn(shape, tmp_path, module=worker)
    for name in worker.CASES[shape]:
        assert f"{name}/decode_logits" in worst and f"{name}/decode_cache_vs_float64" in worst
        assert f"{name}/train/params_beyond_tol_over_lr" in worst
        assert f"{name}/train_bf16_logits/params_beyond_tol_over_lr" in worst
        # over 3 ranks nothing splits; over 2 the blocks' leaves and the vocab
        split = worst[f"{name}/init_split_leaves"]
        assert split == 0 if shape == (1, 3) else split >= 13
    return worst


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2-heads", "1x3-whole"])
def test_recurrent_families_on_a_mesh_equal_one_process(shape, tmp_path):
    worst = check_mesh(shape, tmp_path)
    if shape == (1, 2):
        assert worst["rwkv6-heads4/row_parallel_output_fails"] == 1
        assert worst["zamba2-1.2b/w_in_gather_without_grad_sum_fails_float32_logits"] == 1
        assert worst["zamba2-1.2b/w_in_gather_without_grad_sum_fails_bf16_logits"] == 1
        assert worst["zamba2-1.2b/checkpoint_bitwise"] == 1


def _draw(rng, *shape, scale=None, dtype=torch.float64):
    scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)


def _mamba2(seed, dtype=torch.float64):
    s = S.Mamba2Spec(d_model=64, d_state=8, head_dim=8, chunk=4)
    di, ns, nh = s.d_inner, s.d_state, s.n_heads
    rng = np.random.default_rng(seed)
    p = {"w_in": _draw(rng, 64, 2 * di + 2 * ns + nh, dtype=dtype),
         "conv_w": _draw(rng, s.d_conv, di + 2 * ns, scale=0.5, dtype=dtype),
         "conv_b": _draw(rng, di + 2 * ns, scale=0.1, dtype=dtype),
         "A_log": _draw(rng, nh, scale=0.5, dtype=dtype),
         "D": _draw(rng, nh, scale=1.0, dtype=dtype),
         "dt_bias": _draw(rng, nh, scale=0.5, dtype=dtype),
         "norm": {"scale": _draw(rng, di, scale=0.1, dtype=dtype)},
         "w_out": _draw(rng, di, 64, dtype=dtype)}
    x = _draw(rng, 2, 12, 64, scale=1.0, dtype=dtype)
    return s, p, x


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("M", [2, 16])
def test_mamba2_rank_parts_sum_to_the_layer(M):
    """Mamba2 with 16 heads of 8 over M ranks, float64 weights: each rank's
    heads (``mamba2_heads``: its in-projection columns of the whole
    ``w_in``, its convolution channels, the scan of its heads), the norm's
    squares summed over the ranks, each rank's rows of ``w_out``
    (``mamba2_norm_out``), the parts summed: the layer's output within
    PARTS_TOL (its gate and norm chain is float32 by design), each rank's
    final state the layer's at its heads (within PARTS_TOL: the scan's
    batched products round apart over fewer heads). Then one decode step
    from those states (``decode_mamba2_heads``: each rank its heads' state,
    the whole convolution history, bit for bit) against ``decode_mamba2``:
    the output and the float32 states within PARTS_TOL (the step's
    vectorised exp rounds a row's tail apart from its body)."""
    s, p, x = _mamba2(M)
    di, P = s.d_inner, s.head_dim
    want, final, xBC_in = S.prefill_mamba2(p, s, x)
    Hl = s.n_heads // M
    parts = [S.mamba2_heads(p, s, x, r * Hl, Hl)[:2] for r in range(M)]
    ss = sum(S.sum_squares(g) for g, _ in parts)
    got = sum(S.mamba2_norm_out(p["norm"]["scale"][r * Hl * P:(r + 1) * Hl * P],
                                p["w_out"][r * Hl * P:(r + 1) * Hl * P], g, ss, di, x.dtype)
              for r, (g, _) in enumerate(parts))
    gap = _gap(got, want)
    final_gap = _gap(torch.cat([f for _, f in parts], dim=1), final)
    # one decode step: each rank's state of its heads, the history whole
    tok = _draw(np.random.default_rng(100 + M), 2, 1, 64, scale=1.0)
    cache = {"conv": S.mamba2_conv_tail(s, xBC_in), "ssm": final.float()}  # the cache's dtype
    want_d, _ = S.decode_mamba2(p, s, tok, cache, None)
    proj = tok @ p["w_in"]
    gs, states = [], []
    for r in range(M):
        c = {"conv": S.mamba2_conv_tail(s, xBC_in),
             "ssm": final[:, r * Hl:(r + 1) * Hl].float()}
        gs.append(S.decode_mamba2_heads(p, s, proj, c, r * Hl, Hl))
        states.append(c["ssm"])
        assert torch.equal(c["conv"], cache["conv"])
    ss = sum(S.sum_squares(g) for g in gs)
    got_d = sum(S.mamba2_norm_out(p["norm"]["scale"][r * Hl * P:(r + 1) * Hl * P],
                                  p["w_out"][r * Hl * P:(r + 1) * Hl * P], g, ss, di, x.dtype)
                for r, g in enumerate(gs))
    gap_d = _gap(got_d, want_d)
    state_gap = _gap(torch.cat(states, dim=1), cache["ssm"])
    print(f"M={M}: Mamba2 rank parts vs the layer {gap:.3g}, final state {final_gap:.3g}, "
          f"decode {gap_d:.3g}, state {state_gap:.3g}")
    assert max(gap, final_gap, gap_d, state_gap) <= PARTS_TOL


def _rwkv6(seed):
    s = S.RWKV6Spec(d_model=64, head_dim=16, decay_lora=8, chunk=4)
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    p = {f"mu_{n}": _draw(rng, 64, scale=0.3, dtype=f32) + 0.5 for n in "rkvwg"}
    p.update({k: _draw(rng, 64, 64, dtype=f32) for k in ("wr", "wk", "wv", "wg", "wo")})
    p.update(w0=_draw(rng, 64, scale=0.5, dtype=f32), w1=_draw(rng, 64, 8, dtype=f32),
             w2=_draw(rng, 8, 64, dtype=f32), u=_draw(rng, 64, scale=0.5, dtype=f32),
             ln_out={"scale": _draw(rng, 64, scale=0.1, dtype=f32)})
    x = _draw(rng, 2, 12, 64, scale=1.0, dtype=f32)
    return s, p, x


def _rank_slices(p, r, M):
    """Rank r's time-mix leaves as a model built on the mesh holds them."""
    Dl = 64 // M
    cols = slice(r * Dl, (r + 1) * Dl)
    local = dict(p, **{k: p[k][:, cols] for k in ("wr", "wk", "wv", "wg", "w2")},
                 wo=p["wo"][cols])
    return S.rwkv6_rank_params(local, S.SH.TP(None, M, r))


@pytest.mark.parametrize("train", [False, True], ids=["prefill", "train"])
@pytest.mark.parametrize("M", [2, 4])
def test_rwkv6_time_rank_columns_are_the_layer_output(M, train):
    """RWKV6's time mix with 4 heads of 16 over M ranks (float32): each
    rank's heads (``rwkv6_time_heads``: the scan wrapper, or in training the
    chunked scan), the norm's squares summed over the ranks, ``wo``'s rows
    of its columns (``rwkv6_time_out``): the rank's columns of the layer's
    output, whole, so the ranks' columns side by side (what the
    columns-to-rows all-to-all lays out) are the layer within PARTS_TOL,
    and each rank's final state is the layer's at its heads. The
    row-parallel product that attention's and the MLP's output take, its
    partial sums added as a reduce-scatter adds them, is not: ``wo``
    contracts nothing over its split dim (einsum btd,de->btd), and that sum
    lies a whole output's scale away."""
    s, p, x = _rwkv6(M + 10 * train)
    if train:
        want, final = S.train_rwkv6_time(p, s, x), None
    else:
        want, final, _ = S.apply_rwkv6_time(p, s, x)
    parts = []
    for r in range(M):
        pr = _rank_slices(p, r, M)
        yg, f = S.rwkv6_time_heads(pr, s, x, S._token_shift(x), train=train)
        parts.append((pr, yg))
        if not train:
            Hl = s.n_heads // M
            assert torch.equal(f, final[:, r * Hl:(r + 1) * Hl])
    ss = sum(S.sum_squares(yg) for _, yg in parts)
    cols = torch.cat([S.rwkv6_time_out(pr, yg, ss, s.d_model) for pr, yg in parts], dim=-1)
    gap = _gap(cols, want)
    summed = sum(worker._row_parallel_out(pr, yg, ss, s.d_model) for pr, yg in parts)
    wrong = _gap(summed, want)
    print(f"M={M} train={train}: time-mix columns vs the layer {gap:.3g}; "
          f"row-parallel sum {wrong:.3g}")
    assert gap <= PARTS_TOL
    assert wrong > 0.1


@pytest.mark.parametrize("M", [2, 4])
def test_rwkv6_channel_rank_parts_sum_to_the_layer(M):
    """The channel mix over M ranks (float64): each rank's value path over
    its ``wk`` columns and ``wv`` rows (``rwkv6_channel_part``), summed,
    then the gate on the rows (``rwkv6_channel_gate``): the layer, to float64
    rounding; a decode step's too, from ``x_prev``."""
    rng = np.random.default_rng(M)
    p = {"mu_k": _draw(rng, 64, scale=0.3) + 0.5, "mu_r": _draw(rng, 64, scale=0.3) + 0.5,
         "wk": _draw(rng, 64, 128), "wv": _draw(rng, 128, 64), "wr": _draw(rng, 64, 64)}
    x = _draw(rng, 2, 12, 64, scale=1.0)
    x_prev = _draw(rng, 2, 1, 64, scale=1.0)
    Fl = 128 // M
    for xp, t in ((None, x), (x_prev, x[:, :1])):
        want, _ = S.apply_rwkv6_channel(p, t, xp)
        xs = S._token_shift(t, xp)
        kv = sum(S.rwkv6_channel_part(dict(p, wk=p["wk"][:, r * Fl:(r + 1) * Fl],
                                           wv=p["wv"][r * Fl:(r + 1) * Fl]), t, xs)
                 for r in range(M))
        gap = _gap(S.rwkv6_channel_gate(p, t, xs, kv), want)
        print(f"M={M} decode={xp is not None}: channel-mix parts vs the layer {gap:.3g}")
        assert gap <= PARTS_TOL_F64
