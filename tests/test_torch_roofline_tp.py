"""The roofline's count of a tensor-parallel step (a "model" mesh axis above
1), on fake tensors (``repro_torch.roofline.cost``): nothing allocated.

* internlm2-reduced's train step on ``fake_world((1, 4))`` (heads, ffn and
  vocab split; the data axis of 1 moves nothing): its all-gathers,
  reduce-scatters and all-reduces over "model", call by call and byte by
  byte, equal the closed form written out below per layer and per pass;
  its prefill and a decode step likewise.
* internlm2-1.8b at full width on ``fake_world((16, 16))``, the production
  mesh: the train, prefill and decode steps of the registry's shapes build
  and are counted, the model holding 1/16 of each split leaf.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, ShapeSpec, build_model, get_config  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.roofline.analysis import collective_bytes  # noqa: E402
from repro_torch.roofline.cost import analyze_step, count_step, fake_world  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M, B, S, T = 4, 4, 16, 32
L, D_MODEL, KV, HD = 2, 64, 2, 16  # internlm2-reduced: 2 layers, 4 heads / 2 kv heads
BF16, F32 = 2, 4


def _count(shape):
    with fake_world((1, M)) as mesh:
        model = build_model(get_config("internlm2-1.8b", reduced=True), device="cpu", mesh=mesh)
        return count_step(build_step(model, mesh, shape))


def _totals(calls):
    """(calls, wire bytes) by kind of a list of (kind, in bytes, out bytes)."""
    out = {}
    for kind, i, o in calls:
        n, b = out.get(kind, (0, 0.0))
        out[kind] = (n + 1, b + collective_bytes(kind, i, o))
    return out


def _got(cost, size=M):
    """(calls, wire bytes) by kind of a step's collectives, every one over
    a group of ``size`` (the groups of one move nothing and are not logged)."""
    assert all(n == size for _, n, _, _ in cost.collective_log)
    return _totals([(k, i, o) for k, _, i, o in cost.collective_log])


def test_train_step_collectives_closed_form():
    """Per gatherable block (attention: 4 heads over 4; the MLP: ffn 128
    over 4) one all-gather of its input (B, S/M, d) -> (B, S, d) and one
    reduce-scatter of its output back, in bf16. Per layer: the forward's
    2 + 2; the remat's recompute 2 all-gathers and 1 reduce-scatter (the
    layer's last reduce-scatter feeds no saved tensor, and the
    non-reentrant checkpoint stops before it); the backward's 2 + 2 (each
    collective's transpose). The vocab-parallel lookup reduce-scatters
    (backward: all-gathers), the final rows are gathered over the sequence
    for the logits (backward: reduce-scatter), and the cross entropy
    all-reduces its max, sum of exponents and target logit, (B, S-1)
    float32 each. The update all-reduces the gradients of the leaves that
    "model" does not split (each layer's two norms, wk and wv: the 2 kv
    heads do not divide 4; the final norm) and the clip's squares of the
    12 split leaves."""
    piece, whole = B * S // M * D_MODEL * BF16, B * S * D_MODEL * BF16
    ag, rs = ("all-gather", piece, whole), ("reduce-scatter", whole, piece)
    per_layer = [ag, rs] * 2 + [ag, rs, ag] + [ag, rs] * 2
    ce = [("all-reduce", B * (S - 1) * F32, B * (S - 1) * F32)] * 3
    norm, kv = D_MODEL * BF16, D_MODEL * KV * HD * BF16
    grads = ([("all-reduce", norm, norm)] * 2 + [("all-reduce", kv, kv)] * 2) * L \
        + [("all-reduce", norm, norm)]
    clip = [("all-reduce", 12 * F32, 12 * F32)]
    want = _totals([rs, ag] + per_layer * L + [ag, rs] + ce + grads + clip)
    got = _got(_count(ShapeSpec("t", S, B, "train")))
    print("train over model:", got)
    assert got == want
    assert want["all-gather"][0] == 6 * L + 2 and want["reduce-scatter"][0] == 5 * L + 2


def test_prefill_and_decode_collectives_closed_form():
    """Prefill: per block the gather and the reduce-scatter; the attention
    block's k and v are whole already (the 2 kv heads do not split over
    4); the lookup's reduce-scatter, the last rows' gather and the logits'
    gather over the vocab. Decode: the lookup and each block's output
    all-reduced; the token's q gathered over the heads (k and v are
    whole), the partial outputs (B, H, hd) and log-sum-exps (B, H) in
    float32 gathered; the logits gathered over the vocab."""
    piece, whole = B * S // M * D_MODEL * BF16, B * S * D_MODEL * BF16
    ag, rs = ("all-gather", piece, whole), ("reduce-scatter", whole, piece)
    last = ("all-gather", B * D_MODEL * BF16, M * B * D_MODEL * BF16)
    logits = ("all-gather", B * 256 // M * BF16, B * 256 * BF16)
    want = _totals([rs] + [ag, rs, ag, rs] * L + [last, logits])
    got = _got(_count(ShapeSpec("p", S, B, "prefill")))
    print("prefill over model:", got)
    assert got == want
    H = 4
    tok = B * D_MODEL * BF16
    q = ("all-gather", B * (H // M) * HD * BF16, B * H * HD * BF16)
    part = ("all-gather", B * H * HD * F32, M * B * H * HD * F32)
    lse = ("all-gather", B * H * F32, M * B * H * F32)
    ar = ("all-reduce", tok, tok)
    want = _totals([ar] + [q, part, lse, ar, ar] * L + [logits])
    got = _got(_count(ShapeSpec("d", T, B, "decode")))
    print("decode over model:", got)
    assert got == want


@pytest.mark.parametrize("key", ["train_4k", "prefill_32k", "decode_32k"])
def test_full_width_steps_count_on_the_production_mesh(key):
    with fake_world((16, 16)) as mesh:
        model = build_model(get_config("internlm2-1.8b"), device="cpu", mesh=mesh)
        wq = model.groups[0][0]["b0"]["attn"]["wq"]
        assert tuple(wq.shape) == (2048, 1, 128)  # 16 heads over 16
        built = build_step(model, mesh, SHAPES[key])
        cost = count_step(built)
        report = analyze_step(built, arch="internlm2-1.8b", shape=key, cost=cost)
    assert report.chips == 256 and report.step_time_s > 0
    calls = _got(cost, 16)
    assert calls["all-gather"][0] > 0
    print(key, calls, report.bottleneck, report.step_time_s)
