"""Decoder-only LM stack: the dense family (attention + MLP blocks, with
gemma3's sliding windows and qwen2-vl's M-RoPE), the MoE family (attention
or MLA + routed experts), RWKV6 (time-mix + channel-mix blocks) and
zamba2's hybrid (Mamba2 blocks + shared attention and MLP blocks), for
serving and training.

Port of the reference's ``models/transformer.py``. A model is a sequence of
GROUPS; each group is a PERIOD of blocks repeated ``repeat`` times, then,
after each period, the group's SHARED blocks: one set of weights
(``g{gi}_shared``) applied ``repeat`` times, each application with its own
cache. The reference stacks a group's layers on a leading axis for
``lax.scan``; here each layer is its own ``ParamTree`` in an
``nn.ModuleList`` and the layers run in a Python loop. Blocks are pre-norm
residual: ``x + f(norm(x))``. gemma's embedding scale (``x * sqrt(d_model)``
in the activations' dtype) and the logit soft cap are the reference's.

Serving entry points keep the reference's layouts: tokens (B, S) int, for
M-RoPE optional positions3 (3, B, S) int (t, h, w; by default the token
positions on all three), logits (B, 1, V) bfloat16, and per layer a cache
entry in ``cache[f"g{gi}"][layer][f"b{bi}"]`` (a shared block's in
``f"s{bi}"``):
``{"k", "v"}`` of (B, T, KV, hd) for attention (a sliding-window layer's T
is min(cache_len, window), a ring), ``{"latent", "k_rope"}`` of (B, T,
kv_lora) and (B, T, qk_rope) for MLA, ``{"conv", "ssm"}`` (the last d_conv
- 1 convolution inputs (B, d_conv - 1, conv_dim) and the float32 SSM state
(B, H, N, P)) for Mamba2, ``{"state", "x_prev"}`` (float32 (B, H, K, K) and
the block's last normed input (B, 1, D)) for the RWKV6 time mix,
``{"x_prev"}`` for the channel mix. Decode updates the entries in place.

Training (``loss``) takes the params as a tree (``params()``: the module's
own parameters, one dict per layer in ``g{gi}``'s list, a shared block's in
``g{gi}_shared``), runs each layer under ``torch.utils.checkpoint`` (the
reference's remat) and returns the per-example next-token cross entropy
over bfloat16 logits plus the MoE layers' load-balance loss. No kernel runs
there, as none runs in the reference's training: attention is the plain
``layers.apply_attention``, Mamba2 the chunked SSD scan, RWKV6's time mix
the plain chunked scan (``ssm.train_rwkv6_time``). A group's shared blocks
follow its period's blocks inside the layer's checkpoint, with the one
``g{gi}_shared`` tree, so their gradient sums over the applications. The
encoder-decoder (whisper) is ``models/whisper.py``.

Tensor parallelism (a "model" mesh axis above 1: every block kind and a
group's shared blocks; whisper's encoder-decoder in ``models/whisper.py``): a
model built on such a mesh
(``TransformerLM(cfg, mesh=mesh)``) holds its rank's shards of every leaf
(``lm_param_specs``). Under the step's mesh context the residual stream is
sequence-parallel; a block whose heads or ffn divide the axis gathers its
input over the sequence and reduce-scatters its row-parallel output
(``_gatherable``, the reference's Megatron-SP layout), the others run on
the rank's rows (sequence-parallel attention and MLA, at the rows'
positions: ``positions_local``, M-RoPE's ``positions3_local``). The
embedding, the logits and the cross entropy are vocab-parallel where the
vocab divides the axis (a masked lookup reduced over "model"; the max, the
sum of exponents and the target logit each reduced over it), else computed
on the rank's rows. A prefill returns its caches in the decode layout
(``kv_seq`` over "model": the rank's slots of each full cache, window ring
and MLA latent cache), and decode attends context-parallel
(``layers.decode_attention``, ``layers.decode_mla``). The MoE block gathers
its input over the sequence and hands back its rows (``layers.apply_moe``);
in decode its parts are summed over "model". So do the recurrent blocks
(Mamba2, RWKV6's time and channel mix: ``ssm.apply_mamba2_tp``,
``apply_rwkv6_time_tp``, ``apply_rwkv6_channel_tp``), each rank on its
heads where they divide the axis (their state split by heads), the norm's
squares summed over it; elsewhere the block runs whole on every rank.

Under an fsdp train step (``IplsStepConfig(fsdp=True)``) ``loss`` gathers
each stored leaf where it uses it (``sharding_hooks.gather_stored``): a
layer's inside its checkpoint, the embedding, final norm and head at the
ends.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sharded import (
    DEFAULT_RULES,
    global_shape,
    map_specs,
    model_size,
    shard,
    spec_for_leaf,
)
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import sharding_hooks as SH
from repro_torch.models import ssm as S
from repro_torch.models.param_defs import (
    ParamDef,
    ParamTree,
    axes_tree,
    count_params,
    init_values,
    stack_defs,
    unstack,
    unstack_axes,
)
from repro_torch.models.sharding_hooks import remat_context, shard_act
from repro_torch.tree import tree_map

SUPPORTED_KINDS = ("attn", "mla", "mlp", "moe", "mamba2", "rwkv6_time", "rwkv6_channel")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str                                   # attn|mla|mlp|moe|mamba2|rwkv6_time|rwkv6_channel
    attn: Optional[L.AttnSpec] = None
    mla: Optional[L.MLASpec] = None
    mlp: Optional[L.MLPSpec] = None
    moe: Optional[L.MoESpec] = None
    mamba: Optional[S.Mamba2Spec] = None
    rwkv: Optional[S.RWKV6Spec] = None
    rwkv_ffn: int = 0
    norm: str = "rms"                            # rms | ln


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    blocks: Tuple[BlockSpec, ...]
    repeat: int = 1
    shared: Tuple[BlockSpec, ...] = ()           # applied after blocks, weights shared


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    vocab: int
    d_model: int
    groups: Tuple[GroupSpec, ...]
    tie_embeddings: bool = False
    embed_scale: bool = False                    # gemma: x *= sqrt(d_model)
    final_norm: str = "rms"
    subquadratic: bool = False                   # eligible for long_500k
    mrope: bool = False                          # expects positions3 input
    lb_loss_weight: float = 0.01
    remat: bool = True                           # recompute each layer in backward
    logit_softcap: Optional[float] = None
    # per-arch logical -> mesh rule overrides (granite's expert sharding)
    sharding_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_layers(self) -> int:
        return sum(g.repeat * len(g.blocks) for g in self.groups)


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype``, as a host float: the reference
    multiplies by ``jnp.asarray(sqrt(d), x.dtype)``. Computed once per
    dtype, so that no step reads a tensor's value on the host."""
    # repro: noqa[CG01] a CPU tensor, read once per dtype (lru_cache): no device sync
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def _norm_init(kind: str, d: int):
    return L.init_rmsnorm(d) if kind == "rms" else L.init_layernorm(d)


def _norm_apply(kind: str, p, x):
    return L.rms_norm(p, x) if kind == "rms" else L.layer_norm(p, x)


def _check_kind(b: BlockSpec) -> None:
    if b.kind not in SUPPORTED_KINDS:
        raise NotImplementedError(
            f"block kind {b.kind!r} is not ported: it would belong to a later slice of the port "
            f"(ROADMAP.md queue 1); this one runs {SUPPORTED_KINDS}"
        )


def _attn_positions(b: BlockSpec, ctx: dict, local: bool = False) -> torch.Tensor:
    """An attention or MLA block's positions: (3, B, S) for M-RoPE, else
    (B, S); with ``local``, those of the rank's rows on a tensor-parallel
    mesh (``_tp_ctx``)."""
    key = "positions3" if b.kind == "attn" and b.attn.rope == "mrope" else "positions"
    return ctx[key + "_local" if local else key]


def block_defs(b: BlockSpec, d_model: int) -> Dict[str, Any]:
    _check_kind(b)
    defs: Dict[str, Any] = {"norm": _norm_init(b.norm, d_model)}
    if b.kind == "attn":
        defs["attn"] = L.init_attention(b.attn)
    elif b.kind == "mla":
        defs["mla"] = L.init_mla(b.mla)
    elif b.kind == "mlp":
        defs["mlp"] = L.init_mlp(b.mlp)
    elif b.kind == "moe":
        defs["moe"] = L.init_moe(b.moe)
    elif b.kind == "mamba2":
        defs["mamba"] = S.init_mamba2(b.mamba)
    elif b.kind == "rwkv6_time":
        defs["rwkv"] = S.init_rwkv6_time(b.rwkv)
    else:
        defs["rwkv_ffn"] = S.init_rwkv6_channel(b.rwkv, b.rwkv_ffn)
    return defs


def _sharded_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL in the reference's masked-reduction form (which stays
    local under a vocab-sharded layout): float32 logsumexp minus the target
    logit picked by a comparison with the vocab index."""
    l32 = logits.float()
    m = l32.amax(dim=-1)
    lse = m + torch.log(torch.exp(l32 - m[..., None]).sum(dim=-1))
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    tgt = torch.where(vocab == targets[..., None], l32, 0.0).sum(dim=-1)
    return lse - tgt


def _vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, v0: int, tp) -> torch.Tensor:
    """``_sharded_ce`` of logits whose vocab is split over "model" (this
    rank's columns v0.. of ``logits``): the max, the sum of exponents and
    the target logit each reduced over the axis (the max without a
    gradient: the logsumexp's derivative in it is 0)."""
    l32 = logits.float()
    m = SH.max_model(l32.amax(dim=-1), tp)
    lse = m + torch.log(SH.sum_model(torch.exp(l32 - m[..., None]).sum(dim=-1), tp))
    vocab = torch.arange(logits.shape[-1], device=logits.device) + v0
    tgt = SH.sum_model(torch.where(vocab == targets[..., None], l32, 0.0).sum(dim=-1), tp)
    return lse - tgt


# the recurrent blocks: their input gathered whole over the sequence, their
# rows handed back by the block itself
RECURRENT_KINDS = ("mamba2", "rwkv6_time", "rwkv6_channel")


def _gatherable(b: BlockSpec, M: int) -> bool:
    """The reference's rule: a block gathers its input over the sequence
    (Megatron-SP) when its parallel dim divides the model axis; otherwise
    its weights are replicated and it runs on the rank's rows. The MoE
    block always gathers: its dispatch takes the data rank's whole
    sequence, as the reference's shard_map does, and hands the rank's rows
    back itself (``layers.apply_moe``); so do the recurrent blocks, which
    need the whole sequence anyway (``RECURRENT_KINDS``)."""
    if M == 1:
        return False
    if b.kind in RECURRENT_KINDS:
        return True
    if b.kind == "mlp":
        return b.mlp.d_ff % M == 0
    if b.kind == "attn":
        return b.attn.n_heads % M == 0
    if b.kind == "mla":
        return b.mla.n_heads % M == 0
    return b.kind == "moe"


def seq_rows(S: int, tp) -> Optional[slice]:
    """The rows that a rank holds of a sequence of S on a tensor-parallel
    mesh (``tp``): its share where S divides the axis, as ``_tp_ctx`` cuts
    them, else None: the reference's ``spec_for_leaf`` leaves a dim that
    does not divide the axis replicated, so every rank holds and computes
    the whole sequence (whisper's 1,500 encoder frames or a short prompt
    over 16 ranks)."""
    if tp is None or S % tp.size:
        return None
    Sl = S // tp.size
    return slice(tp.rank * Sl, (tp.rank + 1) * Sl)


def _tp_ctx(ctx: dict, S: int) -> dict:
    """Add the active "model" axis to a pass's ctx, with the rank's rows
    (``rows``: ``seq_rows``) and their positions (and M-RoPE's
    positions3). A sequence that does not split over the axis is whole on
    every rank, as the reference's specs leave it: ``rows`` None, the
    "local" positions all of them."""
    tp = SH.tensor_parallel()
    if tp is None:
        return ctx
    rows = seq_rows(S, tp)
    sl = slice(None) if rows is None else rows
    out = dict(ctx, tp=tp, rows=rows, positions_local=ctx["positions"][:, sl])
    if "positions3" in ctx:
        out["positions3_local"] = ctx["positions3"][:, :, sl]
    return out


def apply_block_train(b: BlockSpec, p, x, ctx: dict):
    """A block's training forward: (``x + f(norm(x))``, its aux loss, 0
    but for MoE), differentiable. The reference gathers a block's input
    over the sequence (Megatron-SP) when its heads or ffn divide a model
    axis above 1 (``_gatherable``), and reduce-scatters its row-parallel
    output back; otherwise the block runs on the rank's rows, its
    attention sequence-parallel. On a model axis of 1 neither happens."""
    tp = ctx.get("tp")
    if tp is not None and ctx["rows"] is None:
        return _apply_block_train_whole(b, p, x, ctx, tp)
    h = _norm_apply(b.norm, p["norm"], x)
    gather = tp is not None and _gatherable(b, tp.size)
    if gather:
        h = SH.gather_seq(h, tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    local = tp is not None and not gather  # the rank's rows
    if b.kind == "attn":
        y = L.apply_attention(p["attn"], b.attn, h, _attn_positions(b, ctx, local))
    elif b.kind == "mla":
        y = L.apply_mla(p["mla"], b.mla, h, _attn_positions(b, ctx, local))
    elif b.kind == "mlp":
        y = L.apply_mlp(p["mlp"], b.mlp, h)
    elif b.kind == "moe":
        y, moe_aux = L.apply_moe(p["moe"], b.moe, h)
        aux = moe_aux["lb_loss"]
    elif b.kind == "mamba2":
        y = (S.apply_mamba2_tp(p["mamba"], b.mamba, h, tp) if gather
             else S.apply_mamba2(p["mamba"], b.mamba, h)[0])
    elif b.kind == "rwkv6_time":
        y = (S.apply_rwkv6_time_tp(p["rwkv"], b.rwkv, h, tp, train=True)[0] if gather
             else S.train_rwkv6_time(p["rwkv"], b.rwkv, h))
    elif gather:
        y = S.apply_rwkv6_channel_tp(p["rwkv_ffn"], b.rwkv_ffn, h, tp)
    else:
        y, _ = S.apply_rwkv6_channel(p["rwkv_ffn"], h)
    # the MoE and recurrent blocks hand back the rank's rows themselves
    if gather and b.kind not in ("moe",) + RECURRENT_KINDS:
        y = SH.scatter_seq(y, tp)
    return shard_act(x + y, ("batch", "act_seq", "embed")), aux


def _apply_block_train_whole(b: BlockSpec, p, x, ctx: dict, tp):
    """``apply_block_train`` on a sequence that does not split over the
    model axis: x whole on every rank. A block whose heads or ffn divide
    the axis (``_gatherable``; the MoE and recurrent blocks too) takes its
    normed input by ``SH.to_parts`` and runs on the rank's heads or
    columns, its row-parallel part all-reduced in float32 and cast once
    (``SH.reduce_parts``; the MoE and recurrent blocks sum or gather their
    own); the others run on every row alike. What every rank computes alike
    counts once in the gradients (``SH.once_whole``): the norm, and every
    leaf of a block that runs alike."""
    gather = _gatherable(b, tp.size)
    defs = block_defs(b, x.shape[-1])
    if gather:
        p = dict(p, norm=SH.once_whole(p["norm"], defs["norm"], tp))
    else:
        p = SH.once_whole(p, defs, tp)
    h = _norm_apply(b.norm, p["norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pos = _attn_positions(b, ctx) if b.kind in ("attn", "mla") else None
    if b.kind == "moe":
        y, moe_aux = L.apply_moe(p["moe"], b.moe, h, seq_split=False)
        aux = moe_aux["lb_loss"]
    elif b.kind == "mamba2":
        y = S.apply_mamba2_tp(p["mamba"], b.mamba, h, tp, whole=True)
    elif b.kind == "rwkv6_time":
        y = S.apply_rwkv6_time_tp(p["rwkv"], b.rwkv, h, tp, train=True, whole=True)[0]
    elif b.kind == "rwkv6_channel":
        y = S.apply_rwkv6_channel_tp(p["rwkv_ffn"], b.rwkv_ffn, h, tp, whole=True)
    elif gather:
        h = SH.to_parts(h, tp)
        if b.kind == "attn":
            y = L.apply_attention(p["attn"], b.attn, h, pos)
        elif b.kind == "mla":
            y = L.apply_mla(p["mla"], b.mla, h, pos)
        else:
            y = L.apply_mlp(p["mlp"], b.mlp, h)
        y = SH.reduce_parts(y, None, tp)
    elif b.kind == "attn":
        y = L.attention_whole(p["attn"], b.attn, h, pos)
    elif b.kind == "mla":
        y = L.prefill_mla_whole(p["mla"], b.mla, h, pos)[0]
    else:
        y = L.apply_mlp(p["mlp"], b.mlp, h)
    return x + y, aux


def block_cache_defs(b: BlockSpec, batch: int, seq_len: int, dtype) -> Optional[Dict[str, Any]]:
    if b.kind == "attn":
        return L.init_attn_cache(b.attn, batch, seq_len, dtype)
    if b.kind == "mla":
        return L.init_mla_cache(b.mla, batch, seq_len, dtype)
    if b.kind == "mamba2":
        return S.init_mamba2_cache(b.mamba, batch, dtype)
    if b.kind in ("mlp", "moe"):
        return None  # stateless
    x_prev = ParamDef((batch, 1, b.rwkv.d_model), ("batch", None, None), init="zeros",
                      dtype=dtype)
    if b.kind == "rwkv6_channel":
        return {"x_prev": x_prev}
    H, K = b.rwkv.n_heads, b.rwkv.head_dim
    return {"state": ParamDef((batch, H, K, K), ("batch", "heads", None, None),
                                      init="zeros", dtype=torch.float32),
            "x_prev": x_prev}


def _apply_block_prefill_tp(b: BlockSpec, p, x, ctx, tp):
    """``apply_block_prefill`` on a tensor-parallel mesh: the layout of
    ``apply_block_train`` (a sequence that does not split, whole on every
    rank: ``_apply_block_train_whole``'s). An attention or MLA block's
    cache takes the decode layout the reference's spec gives each leaf
    (``SH.cache_layout``): the rank's slots of the whole cache (a
    sliding-window layer's: of its ring, filled first) where they divide
    the axis, else its kv heads where those do, else all of it. A
    recurrent block's state is that of the rank's heads (every head where
    they do not divide the axis), its convolution history and last input
    whole."""
    rows = ctx["rows"]
    h = _norm_apply(b.norm, p["norm"], x)
    gather = _gatherable(b, tp.size)
    if gather:
        h = SH.whole_in(h, rows, tp)
    whole = rows is None
    if b.kind == "moe":  # its input whole, its output the rank's rows (or all)
        return x + L.apply_moe(p["moe"], b.moe, h, with_lb=False, seq_split=not whole)[0], None
    if b.kind == "mamba2":
        y, final, tail = S.apply_mamba2_tp(p["mamba"], b.mamba, h, tp, with_cache=True,
                                           whole=whole)
        return x + y, {"conv": tail, "ssm": final.float()}
    if b.kind == "rwkv6_time":
        y, final = S.apply_rwkv6_time_tp(p["rwkv"], b.rwkv, h, tp, whole=whole)
        return x + y, {"state": final, "x_prev": h[:, -1:].clone()}
    if b.kind == "rwkv6_channel":
        y = S.apply_rwkv6_channel_tp(p["rwkv_ffn"], b.rwkv_ffn, h, tp, whole=whole)
        return x + y, {"x_prev": h[:, -1:].clone()}
    if b.kind == "mlp":
        y, entry = L.apply_mlp(p["mlp"], b.mlp, h), None
    else:
        pos = _attn_positions(b, ctx, local=not gather)
        split = gather or not whole  # the layer's own tensor-parallel layout
        if b.kind == "mla":
            y, latent, k_rope = (L.prefill_mla if split else L.prefill_mla_whole)(
                p["mla"], b.mla, h, pos)
            cached, kv = {"latent": latent, "k_rope": k_rope}, None
            T, ring = ctx["cache_len"], False
        else:
            y, k, v = (L.prefill_attention if split else L.prefill_attention_whole)(
                p["attn"], b.attn, h, pos)
            cached, kv = {"k": k, "v": v}, b.attn.kv_heads
            T, ring = L.attn_cache_len(b.attn, ctx["cache_len"]), b.attn.window is not None
        layout = SH.cache_layout(T, kv, tp.size)
        entry = {k: SH.cut_cache(_cache_fill(t, T, ring), layout, tp) for k, t in cached.items()}
    if gather:
        y = SH.scatter_seq(y, tp) if rows is not None else SH.reduce_parts(y, None, tp)
    return x + y, entry


def apply_block_prefill(b: BlockSpec, p, x, ctx):
    """Returns (y, cache_entry)."""
    if "tp" in ctx:
        return _apply_block_prefill_tp(b, p, x, ctx, ctx["tp"])
    h = _norm_apply(b.norm, p["norm"], x)
    if b.kind == "mlp":
        return x + L.apply_mlp(p["mlp"], b.mlp, h), None
    if b.kind == "moe":
        return x + L.apply_moe(p["moe"], b.moe, h, with_lb=False)[0], None
    if b.kind == "mla":
        y, latent, k_rope = L.prefill_mla(p["mla"], b.mla, h, ctx["positions"])
        return x + y, {"latent": _cache_fill(latent, ctx["cache_len"]),
                       "k_rope": _cache_fill(k_rope, ctx["cache_len"])}
    if b.kind == "mamba2":
        y, final, xBC_in = S.prefill_mamba2(p["mamba"], b.mamba, h)
        return x + y, {"conv": S.mamba2_conv_tail(b.mamba, xBC_in), "ssm": final.float()}
    if b.kind == "rwkv6_time":
        y, final, x_last = S.apply_rwkv6_time(p["rwkv"], b.rwkv, h)
        return x + y, {"state": final, "x_prev": x_last.clone()}  # a copy: h is freed
    if b.kind == "rwkv6_channel":
        y, x_last = S.apply_rwkv6_channel(p["rwkv_ffn"], h)
        return x + y, {"x_prev": x_last.clone()}
    y, k, v = L.prefill_attention(p["attn"], b.attn, h, _attn_positions(b, ctx))
    T, ring = L.attn_cache_len(b.attn, ctx["cache_len"]), b.attn.window is not None
    return x + y, {"k": _cache_fill(k, T, ring), "v": _cache_fill(v, T, ring)}


def _cache_fill(t: torch.Tensor, T: int, ring: bool = False) -> torch.Tensor:
    """A zero cache of T slots along dim 1 holding the last min(T, S) of the
    prompt's S entries of ``t``: in its first slots, or, for a ``ring``
    (a sliding-window layer's), the entry of position p in slot p % T, the
    slot decode writes it to (the reference's roll by S % T once the ring
    is full; before that, slot p)."""
    Sq = t.shape[1]
    c = t.new_zeros((t.shape[0], T) + t.shape[2:])
    keep = min(T, Sq)
    if ring:
        slots = torch.arange(Sq - keep, Sq, device=t.device) % T
        return c.index_copy_(1, slots, t[:, Sq - keep:])
    c[:, :keep] = t[:, Sq - keep:]
    return c


def apply_block_decode(b: BlockSpec, p, x, cache, pos, cache_len: Optional[int] = None):
    """One token through a block; attention and RWKV6 caches are updated
    in place. On a tensor-parallel mesh a block with split weights sums its
    row-parallel output over "model" (the MoE block inside ``apply_moe``,
    whose one token a row is whole on every rank; the recurrent blocks
    inside their ``*_tp`` steps). ``cache_len``, the whole caches' slots
    (a full cache's; a window's ring holds min(cache_len, window)), lets an
    attention or MLA block see whether the rank holds a share of its
    cache's slots or all of them (``layers.decode_attention``'s ``slots``)."""
    slots = None if cache_len is None or b.kind not in ("attn", "mla") else (
        L.attn_cache_len(b.attn, cache_len) if b.kind == "attn" else cache_len)
    tp = SH.tensor_parallel()
    if tp is not None and b.kind in RECURRENT_KINDS:
        h = _norm_apply(b.norm, p["norm"], x)
        if b.kind == "mamba2":
            y = S.decode_mamba2_tp(p["mamba"], b.mamba, h, cache, tp)
        elif b.kind == "rwkv6_time":
            y = S.decode_rwkv6_time_tp(p["rwkv"], b.rwkv, h, cache["state"], cache["x_prev"], tp)
        else:
            y = S.apply_rwkv6_channel_tp(p["rwkv_ffn"], b.rwkv_ffn, h, tp, cache["x_prev"])
        if "x_prev" in cache:
            cache["x_prev"].copy_(h)
        return x + y, cache
    if tp is not None and _gatherable(b, tp.size) and b.kind != "moe":
        h = _norm_apply(b.norm, p["norm"], x)
        if b.kind == "mlp":
            y = L.apply_mlp(p["mlp"], b.mlp, h)
        elif b.kind == "mla":
            y, cache = L.decode_mla(p["mla"], b.mla, h, cache, pos, slots)
        else:
            y, cache = L.decode_attention(p["attn"], b.attn, h, cache, pos, slots)
        return x + SH.sum_model(y, tp), cache
    h = _norm_apply(b.norm, p["norm"], x)
    if b.kind == "mlp":
        return x + L.apply_mlp(p["mlp"], b.mlp, h), cache
    if b.kind == "moe":  # on a model axis above 1 its parts summed over the axis
        return x + L.apply_moe(p["moe"], b.moe, h, with_lb=False, seq_split=False)[0], cache
    if b.kind == "mla":
        y, cache = L.decode_mla(p["mla"], b.mla, h, cache, pos, slots)
        return x + y, cache
    if b.kind == "mamba2":
        y, cache = S.decode_mamba2(p["mamba"], b.mamba, h, cache, pos)
        return x + y, cache
    if b.kind == "rwkv6_time":
        y, _, _ = S.decode_rwkv6_time(p["rwkv"], b.rwkv, h, cache["state"], cache["x_prev"])
        cache["x_prev"].copy_(h)
        return x + y, cache
    if b.kind == "rwkv6_channel":
        y, _ = S.apply_rwkv6_channel(p["rwkv_ffn"], h, cache["x_prev"])
        cache["x_prev"].copy_(h)
        return x + y, cache
    y, cache = L.decode_attention(p["attn"], b.attn, h, cache, pos, slots)
    return x + y, cache


def lm_param_defs(cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's declaration of a model's parameters: each group's
    period stacked on a leading ``layers`` axis (drawn stacked, then split
    per layer), and its shared blocks once (``g{gi}_shared``)."""
    defs: Dict[str, Any] = {"embed": L.init_embedding(cfg.vocab, cfg.d_model)}
    for gi, g in enumerate(cfg.groups):
        period = {f"b{bi}": block_defs(b, cfg.d_model) for bi, b in enumerate(g.blocks)}
        defs[f"g{gi}"] = stack_defs(period, g.repeat)
        if g.shared:
            defs[f"g{gi}_shared"] = {f"b{bi}": block_defs(b, cfg.d_model)
                                     for bi, b in enumerate(g.shared)}
    defs["final_norm"] = _norm_init(cfg.final_norm, cfg.d_model)
    if not cfg.tie_embeddings:
        defs["lm_head"] = {
            "table": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed",
                              scale=0.02)
        }
    return defs


def _def_map(fn, tree):
    """``fn`` over the leaves of a tree of ``ParamDef``s (or, ``fn`` taking
    them, of spec tuples under dicts)."""
    if isinstance(tree, dict):
        return {k: _def_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_param_specs(cfg: ArchConfig, mesh, rules: Optional[dict] = None,
                   stacked: bool = False) -> Dict[str, Any]:
    """The spec of every parameter leaf on ``mesh`` (the reference's
    ``spec_for_leaf`` with ``DEFAULT_RULES``, the config's overrides and
    ``rules``): in the layout of ``params()`` (a list per group), or with
    ``stacked`` in the declaration's (each group's period stacked on a
    leading ``layers`` axis, replicated)."""
    merged = dict(DEFAULT_RULES, **cfg.sharding_overrides, **(rules or {}))
    specs = _def_map(lambda d: spec_for_leaf(d.axes, d.shape, mesh, merged), lm_param_defs(cfg))
    if stacked:
        return specs
    out: Dict[str, Any] = {}
    for k, v in specs.items():
        if k.startswith("g") and not k.endswith("_shared"):
            layer = _def_map(lambda sp: sp[1:], v)
            out[k] = [layer for _ in range(cfg.groups[int(k[1:])].repeat)]
        else:
            out[k] = v
    return out


def lm_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The logical axes of a model's ``params()``: the reference's, per
    layer (its stacked ``layers`` axis removed). Nothing is allocated."""
    defs = lm_param_defs(cfg)
    out = {k: axes_tree(v) for k, v in defs.items()
           if not k.startswith("g") or k.endswith("_shared")}
    for gi, g in enumerate(cfg.groups):
        out[f"g{gi}"] = unstack_axes(defs[f"g{gi}"], g.repeat)
    return out


def lm_active_params(cfg: ArchConfig) -> int:
    """Parameters a token passes through, for MODEL_FLOPS = 6 N_active
    tokens (the reference's count, from the declaration): a MoE layer's
    experts count as top_k / num_experts of their weights, a shared block
    once per application, the embedding not (a gather), the unembedding
    product does."""
    total = 0
    for g in cfg.groups:
        for b in g.blocks + g.shared:
            defs = block_defs(b, cfg.d_model)
            n = count_params(defs)
            if b.kind == "moe":
                experts = count_params({k: defs["moe"][k] for k in ("wg", "wu", "wd")})
                n = n - experts + experts * b.moe.top_k // b.moe.num_experts
            total += n * g.repeat
    return total + cfg.vocab * cfg.d_model


class TransformerLM(nn.Module):
    """The LM. Parameters are drawn at construction from ``seed`` on
    ``device``, frozen (``ParamTree``): one per layer in ``groups``, and a
    group's shared blocks in the attribute ``g{gi}_shared``.
    The device is CUDA by default and raises when there is none; pass
    ``device="cpu"`` to run on the CPU. Built with a ``mesh`` whose "model"
    axis is above 1, it keeps only this rank's shard of each leaf
    (``param_specs``), bit for bit the same slice of the one-process draw
    from the same seed, and its steps must run on that mesh."""

    def __init__(self, cfg: ArchConfig, device="cuda", seed: int = 0, mesh=None):
        super().__init__()
        for g in cfg.groups:
            for b in g.blocks + g.shared:
                _check_kind(b)
        device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh if model_size(mesh) > 1 else None
        cut = None
        if self.mesh is not None:
            stacked = lm_param_specs(cfg, mesh, stacked=True)

            def cut(path, value):
                spec = stacked
                for k in path:
                    spec = spec[k]
                return shard(value, spec, mesh, ("model",))

        gen = torch.Generator(device=device).manual_seed(seed)
        values = init_values(self.param_defs(), gen, device, cut)
        self.embed = ParamTree(values["embed"])
        self.groups = nn.ModuleList(
            nn.ModuleList(ParamTree(p) for p in unstack(values.pop(f"g{gi}"), g.repeat))
            for gi, g in enumerate(cfg.groups)
        )
        for gi, g in enumerate(cfg.groups):
            if g.shared:
                setattr(self, f"g{gi}_shared", ParamTree(values.pop(f"g{gi}_shared")))
        self.final_norm = ParamTree(values["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree(values["lm_head"])

    def param_defs(self) -> Dict[str, Any]:
        return lm_param_defs(self.cfg)

    def params(self) -> Dict[str, Any]:
        """The parameters as a tree (the module's own tensors, no copies):
        ``embed``, ``final_norm``, ``lm_head`` and, per group ``g{gi}``, a
        list of per-layer dicts, and its shared blocks' dict
        ``g{gi}_shared``. A train step that updates the tree in place
        updates the module."""
        out: Dict[str, Any] = {k: getattr(self, k).as_dict()
                               for k in ("embed", "final_norm", "lm_head") if hasattr(self, k)}
        for gi, layers in enumerate(self.groups):
            out[f"g{gi}"] = [p.as_dict() for p in layers]
            if self.cfg.groups[gi].shared:
                out[f"g{gi}_shared"] = getattr(self, f"g{gi}_shared").as_dict()
        return out

    def axes(self) -> Dict[str, Any]:
        return lm_axes(self.cfg)

    def param_shapes(self) -> Dict[str, Any]:
        """``params()`` as meta tensors: shapes and dtypes, no storage (on a
        tensor-parallel mesh, this rank's shards)."""
        return tree_map(lambda p: torch.empty_like(p, device="meta"), self.params())

    @property
    def param_specs(self) -> Optional[Dict[str, Any]]:
        """The specs of ``params()`` on the model's mesh (None without one)."""
        return None if self.mesh is None else lm_param_specs(self.cfg, self.mesh)

    def global_param_shapes(self) -> Dict[str, Any]:
        """The whole leaves' shapes as meta tensors (``param_shapes`` but
        for a model built on a tensor-parallel mesh)."""
        local = self.param_shapes()
        if self.mesh is None:
            return local
        return map_specs(
            lambda t, sp: torch.empty(global_shape(t.shape, sp, self.mesh, ("model",)),
                                      dtype=t.dtype, device="meta"),
            local, self.param_specs)

    def num_params(self) -> int:
        return count_params(self.param_defs())

    def num_active_params(self) -> int:
        return lm_active_params(self.cfg)

    def kernel_launches(self) -> Dict[str, Dict[str, int]]:
        """The kernel launches of one prefill and of one decode step on
        CUDA, by kernel wrapper: flash attention in the prefill and
        flash-decode in a decode step once per attention block applied (a
        group's shared blocks once per layer), the linear scan once per
        time-mix block in the prefill (its decode is one recurrent step in
        plain PyTorch)."""
        def count(kind: str) -> int:
            return sum(b.kind == kind for g in self.cfg.groups
                       for b in (g.blocks + g.shared) * g.repeat)

        n_attn = count("attn")
        return {"prefill": {"flash_attention": n_attn, "rwkv6_scan": count("rwkv6_time")},
                "decode_step": {"decode_attention": n_attn}}

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    # -- pieces ---------------------------------------------------------------
    def _head_key(self) -> str:
        return "embed" if self.cfg.tie_embeddings else "lm_head"

    @staticmethod
    def _top(params, *keys) -> Dict[str, Any]:
        """Top-level leaves of ``params`` as the loss uses them: under an
        fsdp step each stored one gathered whole (``gather_stored``), once
        for each use (a tied table twice: lookup and logits)."""
        return SH.gather_stored({k: params[k] for k in keys})

    def _logits(self, x, params=None):
        """bfloat16 logits of a float32-accumulated product with the
        (tied or separate) unembedding table, of ``params`` (a tree) or of
        the module; with ``logit_softcap`` c, c tanh(logits / c) in float32,
        rounded to bfloat16 again."""
        key = self._head_key()
        table = getattr(self, key).table if params is None else params[key]["table"]
        logits = (x @ table.t()).to(torch.bfloat16)
        c = self.cfg.logit_softcap
        if c:
            logits = (torch.tanh(logits.float() / c) * c).to(torch.bfloat16)
        return logits

    def _tensor_parallel(self):
        """The active "model" axis (above 1) of the step's mesh context, or
        None; a model built on such a mesh runs only under its context, and
        a model built without one never under it."""
        tp = SH.tensor_parallel()
        if (tp is None) != (self.mesh is None):
            raise RuntimeError(
                "a model built on a mesh with a 'model' axis above 1 runs under that mesh's "
                "step context (launch/steps.py), and only such a model does: build it with "
                "build_model(cfg, mesh=mesh)")
        return tp

    def _vocab_split(self, params=None) -> bool:
        """Whether the unembedding table's rows are split over "model"."""
        key = self._head_key()
        table = getattr(self, key).table if params is None else params[key]["table"]
        return table.shape[0] < self.cfg.vocab

    def _logits_whole(self, x, tp):
        """``_logits`` with every vocab column on every rank (serving)."""
        logits = self._logits(x)
        if tp is not None and self._vocab_split():
            logits = SH.gather_model(logits, tp, logits.dim() - 1)
        return logits

    def _embed_in(self, tokens, params=None, tp=None, seq_split: bool = True):
        """The tokens' embeddings (of ``params`` or of the module); with
        ``embed_scale``, times sqrt(d_model) rounded to their dtype first,
        as the reference multiplies (a host float: no device copy). On a
        tensor-parallel mesh (``tp``), the rank's rows of the sequence
        (``seq_split``) or the whole of it: vocab-parallel where the table
        is split, else a lookup of those tokens."""
        table = self.embed if params is None else params["embed"]
        if tp is None:
            x = L.embed(table, tokens)
        elif table["table"].shape[0] < self.cfg.vocab:
            x = L.embed_vocab_parallel(table, tokens, tp, seq_split)
        else:
            if seq_split:
                Sl = tokens.shape[1] // tp.size
                tokens = tokens[:, tp.rank * Sl:(tp.rank + 1) * Sl]
            x = L.embed(table, tokens)
        if self.cfg.embed_scale:
            x = x * _embed_scale(self.cfg.d_model, x.dtype)
        return x

    def _layers(self):
        """(group, layer, cache key, block spec, block params) of every
        block in order: each layer's blocks ``b{bi}``, then its group's
        shared blocks ``s{bi}`` (one set of weights for every layer)."""
        for gi, g in enumerate(self.cfg.groups):
            shared = getattr(self, f"g{gi}_shared", None)
            for li, p in enumerate(self.groups[gi]):
                for bi, b in enumerate(g.blocks):
                    yield gi, li, f"b{bi}", b, p[f"b{bi}"]
                for bi, b in enumerate(g.shared):
                    yield gi, li, f"s{bi}", b, shared[f"b{bi}"]

    def _put(self, caches, gi: int, li: int, key: str, entry) -> None:
        """``caches[f"g{gi}"][li][key] = entry``, one dict per layer."""
        layers = caches.setdefault(f"g{gi}", [{} for _ in range(self.cfg.groups[gi].repeat)])
        layers[li][key] = entry

    def _ctx(self, batch, tokens: torch.Tensor, cache_len: int = 0) -> dict:
        """The positions of a pass over ``tokens`` (B, S): (B, S) token
        positions and, for M-RoPE, ``batch["positions3"]`` (3, B, S) on the
        model's device, or the token positions on all three components (the
        reference's ``_ctx``)."""
        B, Sq = tokens.shape
        positions = torch.arange(Sq, device=self.device)[None, :].expand(B, Sq)
        ctx = {"positions": positions, "cache_len": cache_len}
        if self.cfg.mrope:
            p3 = batch.get("positions3")
            ctx["positions3"] = (positions[None].expand(3, B, Sq) if p3 is None
                                 else torch.as_tensor(p3).to(self.device))
        return ctx

    # -- training ----------------------------------------------------------------
    def _stack_apply_train(self, params, x, ctx):
        """Every layer's blocks in order, then its group's shared blocks
        (``g{gi}_shared``, the same tree in every layer), and the sum of
        their aux losses; with ``cfg.remat`` each layer runs under
        ``torch.utils.checkpoint`` (its activations recomputed in the
        backward pass, the reference's ``jax.checkpoint`` of its scan
        body), the recompute under the forward's sharding context. Under an
        fsdp step each layer gathers its stored leaves inside its
        checkpoint, so no layer's whole weights outlive it."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, g in enumerate(self.cfg.groups):
            shared = params.get(f"g{gi}_shared")
            for lp in params[f"g{gi}"]:
                def layer(x, aux, g=g, lp=lp, shared=shared):
                    # fsdp: the layer's stored leaves (and its period's shared
                    # blocks) whole for this layer only, again in the recompute
                    lp, shared = SH.gather_stored(lp), SH.gather_stored(shared)
                    for bi, b in enumerate(g.blocks):
                        x, a = apply_block_train(b, lp[f"b{bi}"], x, ctx)
                        aux = aux + a
                    for bi, b in enumerate(g.shared):
                        x, a = apply_block_train(b, shared[f"b{bi}"], x, ctx)
                        aux = aux + a
                    return x, aux

                if self.cfg.remat:
                    x, aux_total = checkpoint(layer, x, aux_total, use_reentrant=False,
                                              context_fn=remat_context)
                else:
                    x, aux_total = layer(x, aux_total)
        return x, aux_total

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy plus ``lb_loss_weight`` times the MoE
        layers' load-balance loss over the layer count. batch: tokens (B, S)
        int. Returns (per_example_loss (B,) float32, {"lb_loss": the
        layers' summed load-balance loss}), differentiable in ``params`` (a
        tree as ``params()`` gives). M-RoPE takes ``batch["positions3"]``
        as ``prefill`` does. The logits are bfloat16 (a
        float32-accumulated product), the CE in float32."""
        tokens = batch["tokens"].to(self.device).long()
        ctx = self._ctx(batch, tokens)
        tp = self._tensor_parallel()
        if tp is not None:
            return self._loss_tp(params, tokens, _tp_ctx(ctx, tokens.shape[1]), tp)
        x = shard_act(self._embed_in(tokens, self._top(params, "embed")),
                      ("batch", "act_seq", "embed"))
        x, aux = self._stack_apply_train(params, x, ctx)
        head = self._top(params, "final_norm", self._head_key())
        x = _norm_apply(self.cfg.final_norm, head["final_norm"], x)
        x = shard_act(x, ("batch", None, "embed"))
        logits = shard_act(self._logits(x[:, :-1], head), ("batch", None, "vocab"))
        nll = _sharded_ce(logits, tokens[:, 1:])
        per_ex = nll.mean(dim=-1) + self.cfg.lb_loss_weight * aux / max(self.cfg.n_layers, 1)
        return per_ex, {"lb_loss": aux}

    def _loss_tp(self, params, tokens, ctx, tp):
        """``loss`` on a tensor-parallel mesh: the sequence-parallel stack,
        then, with the vocab split, the final rows gathered over the
        sequence and the vocab-parallel CE; else each rank's rows'
        logits and CE, their sum reduced over "model". On a sequence that
        does not split (``ctx["rows"]`` None) the stack runs whole on every
        rank (``_apply_block_train_whole``), the embedding, final norm and
        head whole too (counted once in the gradients where "model" does
        not split them), and, with the vocab split, the final rows enter
        the vocab-parallel CE by ``SH.to_parts``. Every rank returns the
        whole loss."""
        S = tokens.shape[1]
        rows = ctx["rows"]
        top = self._top(params, "embed")
        if rows is None:
            top = self._once_top(top, tp)
        x = self._embed_in(tokens, top, tp, seq_split=rows is not None)
        x, aux = self._stack_apply_train(params, x, ctx)
        head = self._top(params, "final_norm", self._head_key())
        if rows is None:
            head = self._once_top(head, tp)
        x = _norm_apply(self.cfg.final_norm, head["final_norm"], x)
        if self._vocab_split(head):
            x = SH.whole_in(x, rows, tp)
            logits = self._logits(x[:, :-1], head)
            nll = _vocab_parallel_ce(logits, tokens[:, 1:], tp.rank * logits.shape[-1], tp)
            total = nll.mean(dim=-1)
        elif rows is None:
            total = _sharded_ce(self._logits(x[:, :-1], head), tokens[:, 1:]).mean(dim=-1)
        else:
            lo = tp.rank * x.shape[1]
            tgt = tokens[:, lo + 1:lo + x.shape[1] + 1]
            nll = _sharded_ce(self._logits(x[:, :tgt.shape[1]], head), tgt)
            total = SH.sum_model(nll.sum(dim=-1), tp) / (S - 1)
        per_ex = total + self.cfg.lb_loss_weight * aux / max(self.cfg.n_layers, 1)
        return per_ex, {"lb_loss": aux}

    def _once_top(self, tree, tp):
        """Top-level leaves (embedding, final norm, head) that every rank
        uses alike on a sequence that does not split over the model axis,
        each marked to count once in the gradients where "model" does not
        split it (``SH.once_whole``)."""
        d = self.cfg.d_model
        defs = {"embed": L.init_embedding(self.cfg.vocab, d),
                "lm_head": L.init_embedding(self.cfg.vocab, d),
                "final_norm": _norm_init(self.cfg.final_norm, d)}
        return SH.once_whole(tree, {k: defs[k] for k in tree}, tp)

    # -- serving ---------------------------------------------------------------
    def cache_defs(self, batch: int, cache_len: int, dtype=None) -> Dict[str, Any]:
        """The cache's declaration in the port's layout (the reference's
        ``cache_defs`` with each group's layers unstacked): ``g{gi}`` a list
        of per-layer dicts of ``ParamDef``s under ``b{bi}`` / ``s{bi}``, for
        the blocks that keep a cache. KV and MLA caches, Mamba2 convolution
        histories and RWKV6 ``x_prev`` in ``dtype`` (the model's by default:
        the reference's is bfloat16 whatever the weights, the port's decode
        needs the activations' dtype), Mamba2 and RWKV6 states in float32."""
        dtype = dtype or self.dtype
        defs: Dict[str, Any] = {}
        for gi, li, key, b, _ in self._layers():
            entry = block_cache_defs(b, batch, cache_len, dtype)
            if entry is not None:
                self._put(defs, gi, li, key, entry)
        return defs

    def init_cache(self, batch: int, cache_len: int, dtype=None):
        """Zero caches of ``cache_defs``, on the model's device."""
        return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype, device=self.device),
                        self.cache_defs(batch, cache_len, dtype))

    @torch.no_grad()
    def prefill(self, batch):
        """Full-prompt forward. batch: tokens (B, S) int, optional cache_len
        (default S) and, for M-RoPE, positions3 (3, B, S) int. Returns
        (last-token logits (B, 1, V) bf16, cache) with the prompt's keys and
        values (MLA: latents and rope keys) in slots 0..S-1 of a new cache (a
        sliding-window layer's ring: position p in slot p % T), each Mamba2
        block's last convolution inputs and final state, and each RWKV6
        block's final state and last normed input."""
        tokens = batch["tokens"].to(self.device)
        ctx = self._ctx(batch, tokens, batch.get("cache_len", tokens.shape[1]))
        tp = self._tensor_parallel()
        rows = None
        if tp is not None:
            ctx = _tp_ctx(ctx, tokens.shape[1])
            rows = ctx["rows"]
        x = self._embed_in(tokens, tp=tp, seq_split=rows is not None)
        caches: Dict[str, Any] = {}
        for gi, li, key, b, p in self._layers():
            x, c = apply_block_prefill(b, p, x, ctx)
            if c is not None:
                self._put(caches, gi, li, key, c)
        last = x[:, -1:] if rows is None else SH.gather_model(x[:, -1:], tp, 1)[:, -1:]
        x = _norm_apply(self.cfg.final_norm, self.final_norm, last)
        return self._logits_whole(x, tp), caches

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One new token. batch: token (B, 1) int, pos () int32 (a 0-d tensor
        on the model's device, or an int): the number of tokens already
        cached (M-RoPE rotates the token at pos on all three components, as
        the reference does). Unlike the reference, which returns a new
        cache, this writes the token's keys and values, the Mamba2 and RWKV6
        states and the last inputs into ``cache`` IN PLACE and returns it
        with the logits (B, 1, V) bf16. Under a step whose context-parallel
        group is above 1 the batch's host int ``cache_len`` gives the whole
        caches' slots (``build_decode_step`` passes its shape's): each
        layer decodes context-parallel where the rank holds a share of its
        cache's slots, else on the cache it holds (a layout per layer)."""
        token = batch["token"].to(self.device)
        pos = torch.as_tensor(batch["pos"], dtype=torch.int32, device=self.device)
        tp = self._tensor_parallel()
        cache_len = batch.get("cache_len")
        if cache_len is None and SH.context_parallel() is not None:
            raise ValueError("a decode step whose context-parallel group is above 1 needs the "
                             "whole caches' slots as batch['cache_len'] (build_decode_step "
                             "passes its shape's): a rank's cache alone does not say whether it "
                             "is a share or the whole")
        x = self._embed_in(token, tp=tp, seq_split=False)
        for gi, li, key, b, p in self._layers():
            entry = cache[f"g{gi}"][li].get(key) if f"g{gi}" in cache else None
            x, _ = apply_block_decode(b, p, x, entry, pos, cache_len)
        x = _norm_apply(self.cfg.final_norm, self.final_norm, x)
        return self._logits_whole(x, tp), cache
