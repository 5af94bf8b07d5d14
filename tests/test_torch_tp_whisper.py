"""whisper (the encoder-decoder) over a "model" mesh axis above 1 on gloo
meshes of CPU processes, in float32, one spawn of
``tests/torch_tp_whisper_worker.py`` per mesh (its docstring gives every
bound):

* (1, 2): whisper-reduced head-parallel (its 4 heads, d_ff 128 and vocab
  256 split: vocab-parallel embedding, logits and CE), and the
  production layout of whisper-base at 16 ranks (``whisper-prod``: 3
  heads and a vocab of 251 whole, d_ff 128 split), each with encoder
  frames and tokens that split over the axis and that do not (run whole
  on every rank), and caches split by slots, by kv heads, or whole;
* (1, 3): nothing of whisper-reduced splits; 12 frames and tokens split
  into rows, 10 run whole;
* (2, 2) with fsdp (``test_torch_tp_whisper_fsdp.py``).

Each mesh holds the init (the rank's shards the one-process draw's
slices, bit for bit), one train step per (frames, tokens) case, and a
prefill and 8 decode steps per serve case, against the port in one
process. In one process, without a spawn: the cache layouts follow the
reference's ``spec_for_leaf``, and the sequence rows follow its rule.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.sharded import DEFAULT_RULES, spec_for_leaf  # noqa: E402
from repro_torch.models.sharding_hooks import TP  # noqa: E402
from repro_torch.models.transformer import seq_rows  # noqa: E402
from repro_torch.models.whisper import cache_layout  # noqa: E402

import torch_tp_whisper_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401


def check_mesh(shape, tmp_path):
    worst = _spawn(shape, tmp_path, module=worker)
    M = shape[1]
    for name in worker.CASES[shape]:
        for S_enc, S in worker.TRAIN_CASES[M]:
            key = f"{name}/train_enc{S_enc}_tok{S}"
            assert f"{key}/gradients_vs_float64" in worst and f"{key}/metric_loss" in worst
        assert f"{name}/decode_logits" in worst and f"{name}/decode_cache_vs_float64" in worst
        split = worst[f"{name}/init_split_leaves"]
        # over 3 nothing splits; over 2 whisper-reduced splits its attention,
        # MLP and table leaves, the production layout its MLP's alone
        assert split == (0 if shape == (1, 3) else {"whisper-base": 55, "whisper-prod": 12}[name])
    return worst


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2-heads", "1x3-whole"])
def test_whisper_on_a_mesh_equals_one_process(shape, tmp_path):
    worst = check_mesh(shape, tmp_path)
    layouts = {k.split("/", 1)[1] for k in worst if "/layout_" in k}
    if shape == (1, 2):  # slots, kv heads and whole caches, self and cross
        assert {"layout_self_slots_cross_slots", "layout_self_heads_cross_heads",
                "layout_self_whole_cross_whole", "layout_self_slots_cross_whole",
                "layout_self_whole_cross_slots", "layout_self_slots_cross_heads",
                "layout_self_heads_cross_slots"} <= layouts
    else:
        assert {"layout_self_slots_cross_slots", "layout_self_whole_cross_whole"} <= layouts


@pytest.mark.parametrize("T,KV,M,want", [(144, 8, 16, "slots"), (1500, 8, 16, "whole"),
                                         (25, 4, 2, "heads"), (25, 3, 2, "whole"),
                                         (24, 3, 2, "slots")])
def test_cache_layout_is_the_reference_spec(T, KV, M, want):
    """``cache_layout``: the model axis's place in the reference's spec of a
    (B, T, KV, hd) cache whose axes are ("batch", "kv_seq", "kv_heads",
    None), under the decode rules (whisper-base at 16 ranks: its 144-slot
    self cache split 9 a rank, its 1,500 frames' ek and ev whole)."""
    spec = spec_for_leaf(("batch", "kv_seq", "kv_heads", None), (4, T, KV, 64),
                         {"data": 1, "model": M}, dict(DEFAULT_RULES, batch="data"))
    got = "slots" if spec[1] == "model" else "heads" if spec[2] == "model" else "whole"
    assert got == want == cache_layout(T, KV, M)


def test_sequence_rows_split_where_they_divide():
    """``seq_rows``: a rank's share of a sequence that divides the axis, in
    rank order, and none (every row, on every rank) of one that does not."""
    assert seq_rows(12, TP(None, 3, 2)) == slice(8, 12)
    assert seq_rows(1500, TP(None, 16, 5)) is None
    assert seq_rows(4096, TP(None, 16, 15)) == slice(3840, 4096)
    assert seq_rows(9, None) is None
