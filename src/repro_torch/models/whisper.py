"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), for serving
and training.

Port of the reference's ``models/whisper.py``. The convolutional mel
frontend is a stub, as there: the encoder takes precomputed frame
embeddings (B, S_enc, d_model). The backbone is the reference's, quirks
included: a bidirectional encoder with sinusoidal positions (the
reference's divisor ``max(d // 2 - 1, 1)``), a causal decoder with learned
positions (``pos_dec``, rounded to bfloat16 before the add) and
cross-attention, layer norms, the reference's gated GeGLU MLP (tanh GELU),
biases on q, k and v, and tied logits accumulated in float32 and rounded to
bfloat16.

Each encoder and decoder layer is its own ``ParamTree`` in ``enc`` and
``dec`` (the reference stacks them for ``lax.scan``). The attention runs
through the port's kernels: the encoder's self-attention is the flash
kernel without the causal mask, the decoder's self-attention the flash
kernel (prefill) and the flash-decode kernel over its cache (decode), and
its cross-attention the flash kernel with the prompt's Sq rows against the
S_enc encoder keys (prefill) and the flash-decode kernel over all of them
(decode). The cache, per decoder layer, holds the self-attention's k and v
(B, cache_len, KV, hd) and the encoder's ek and ev (B, S_enc, KV, hd), as
in the reference, and, once, ``enc_last``: a 0-d int32 device tensor
holding S_enc - 1, the decode kernel's last key, so a step needs no host
sync. Decode writes the self-attention cache in place.

Training (``loss``) reads the params as a tree (``params()``), not the
module: ``train_encode`` and ``decode_stack`` are the reference's encoder and
teacher-forced decoder with its plain attention (``layers.apply_attention``
and ``_sdpa`` for the cross-attention; no kernel, as in the reference's
training), each layer under ``torch.utils.checkpoint`` when ``cfg.remat``.
Under an fsdp train step each layer gathers its stored leaves inside its
checkpoint, and the embedding (twice: lookup and logits), ``pos_dec`` and
the final norms are gathered where they are used.

On a "model" mesh axis above 1 (``WhisperModel(cfg, mesh=mesh)``: this
rank's shards under the reference's ``spec_for_leaf``) each leaf, sequence
and cache takes the reference's rule: split where it divides the axis,
whole on every rank where it does not. Attention is head-parallel where
the heads divide (its input whole over the sequence, its part reduced),
else on the rank's rows against k and v gathered (the encoder's rows
without a mask, the decoder's causal at their offset, cross-attention's
against the encoder output whole), else, on a sequence that does not
split, every row on every rank alike; the MLP column- then row-parallel
where d_ff divides, its parts summed in float32; the tied logits and the
CE vocab-parallel where the vocab divides, else each rank's rows against
the whole table with their targets one token on. The prefill returns its
caches in the decode layout (``cache_layout``: the self cache and ek, ev
split by slots, else by kv heads, else whole) and decode attends
context-parallel over split slots (``layers._decode_attention_cp``,
``_cross_decode_cp``). whisper-base at 16 ranks: 8 heads, 51,865 vocab
rows, 1,500 frames and short prompts whole; d_ff 2,048 and 4,096- or
32,768-token sequences split.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
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
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models import layers as L
from repro_torch.models import sharding_hooks as SH
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
from repro_torch.models.sharding_hooks import cache_layout, gather_stored, remat_context, shard_act
from repro_torch.models.transformer import (
    TransformerLM,
    _def_map,
    _sharded_ce,
    _vocab_parallel_ce,
    seq_rows,
)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "whisper-base"
    vocab: int = 51865
    d_model: int = 512
    n_heads: int = 8
    kv_heads: int = 8
    d_ff: int = 2048
    enc_layers: int = 6
    dec_layers: int = 6
    max_positions: int = 4096
    remat: bool = True  # training: each layer under torch.utils.checkpoint
    subquadratic: bool = False
    mrope: bool = False
    sharding_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return self.enc_layers + self.dec_layers


def _attn_spec(cfg: WhisperConfig, causal: bool) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                      head_dim=cfg.head_dim, causal=causal, rope="none", bias=True)


def _mlp_spec(cfg: WhisperConfig) -> L.MLPSpec:
    return L.MLPSpec(cfg.d_model, cfg.d_ff, "gelu")  # gated, as the reference's default


def _sinusoid(S: int, d: int) -> np.ndarray:
    pos = np.arange(S)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (dim / max(d // 2 - 1, 1)))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _sinusoid_on(S: int, d: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_sinusoid`` in ``dtype`` on ``device``, copied there once."""
    return torch.from_numpy(_sinusoid(S, d)).to(device=device, dtype=dtype)


def _enc_layer_defs(cfg: WhisperConfig) -> Dict[str, Any]:
    return {
        "ln1": L.init_layernorm(cfg.d_model),
        "attn": L.init_attention(_attn_spec(cfg, causal=False)),
        "ln2": L.init_layernorm(cfg.d_model),
        "mlp": L.init_mlp(_mlp_spec(cfg)),
    }


def _dec_layer_defs(cfg: WhisperConfig) -> Dict[str, Any]:
    return {
        "ln1": L.init_layernorm(cfg.d_model),
        "self_attn": L.init_attention(_attn_spec(cfg, causal=True)),
        "ln2": L.init_layernorm(cfg.d_model),
        "cross_attn": L.init_attention(_attn_spec(cfg, causal=False)),
        "ln3": L.init_layernorm(cfg.d_model),
        "mlp": L.init_mlp(_mlp_spec(cfg)),
    }


def whisper_param_defs(cfg: WhisperConfig) -> Dict[str, Any]:
    """The reference's declaration: each stack of layers on a leading
    ``layers`` axis (drawn stacked, then split per layer)."""
    return {
        "embed": L.init_embedding(cfg.vocab, cfg.d_model),
        "pos_dec": ParamDef((cfg.max_positions, cfg.d_model), (None, "embed"), init="embed",
                            scale=0.01),
        "enc": stack_defs(_enc_layer_defs(cfg), cfg.enc_layers),
        "dec": stack_defs(_dec_layer_defs(cfg), cfg.dec_layers),
        "enc_ln": L.init_layernorm(cfg.d_model),
        "dec_ln": L.init_layernorm(cfg.d_model),
    }


def whisper_axes(cfg: WhisperConfig) -> Dict[str, Any]:
    """The logical axes of a model's parameters: the reference's, per layer
    in ``enc`` and ``dec`` (its stacked ``layers`` axis removed). Nothing
    is allocated."""
    defs = whisper_param_defs(cfg)
    out = {k: axes_tree(v) for k, v in defs.items() if k not in ("enc", "dec")}
    out["enc"] = unstack_axes(defs["enc"], cfg.enc_layers)
    out["dec"] = unstack_axes(defs["dec"], cfg.dec_layers)
    return out


def whisper_param_specs(cfg: WhisperConfig, mesh, rules=None, stacked: bool = False):
    """The spec of every parameter leaf on ``mesh`` (the reference's
    ``spec_for_leaf`` with ``DEFAULT_RULES``, the config's overrides and
    ``rules``): in the layout of ``params()`` (a list per stack), or with
    ``stacked`` in the declaration's (``enc`` and ``dec`` stacked on a
    leading ``layers`` axis, replicated)."""
    merged = dict(DEFAULT_RULES, **cfg.sharding_overrides, **(rules or {}))
    specs = _def_map(lambda d: spec_for_leaf(d.axes, d.shape, mesh, merged),
                     whisper_param_defs(cfg))
    if stacked:
        return specs
    out = {k: v for k, v in specs.items() if k not in ("enc", "dec")}
    for key, n in (("enc", cfg.enc_layers), ("dec", cfg.dec_layers)):
        layer = _def_map(lambda sp: sp[1:], specs[key])
        out[key] = [layer for _ in range(n)]
    return out


def _heads_split(p, s: L.AttnSpec) -> bool:
    return p["wq"].shape[1] < s.n_heads


def _pos_bf16(rows: torch.Tensor) -> torch.Tensor:
    """Training's ``pos_dec`` rows, rounded to bfloat16 before the add, as
    the reference adds them."""
    return rows.to(torch.bfloat16)


def _tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Training's logits: a float32-accumulated product with the tied
    table, rounded to bfloat16."""
    return (x @ table.t()).to(torch.bfloat16)


def _cross_sdpa(p, s: L.AttnSpec, h: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Training cross-attention: every row of h over every frame of enc (the
    encoder's keys and values with their biases, ``_sdpa`` with no mask),
    on the heads the weights hold."""
    ek, ev = L.cross_kv(p, s, enc)
    with L._span("sdpa"):
        out = L._sdpa(L._cross_q(p, s, h), ek, ev, None, s.n_heads // s.kv_heads)
    return L._out_proj(out, p["wo"])


def _attention_train(p, s: L.AttnSpec, h, rows, tp):
    """Training self-attention on a tensor-parallel mesh: head-parallel
    where the heads divide the axis (h whole over the sequence, the
    rank's heads, its part reduced), else on the rank's ``rows`` against k
    and v gathered over the sequence (``layers._apply_attention_tp``:
    the causal mask at the rows' offset, none for the encoder), else, where
    the sequence does not split, every row on every rank alike."""
    if _heads_split(p, s):
        return SH.reduce_parts(L.apply_attention(p, s, SH.whole_in(h, rows, tp), None), rows, tp)
    if rows is not None:
        return L.apply_attention(p, s, h, None)
    return L.attention_whole(p, s, h, None)


def _attention_prefill(p, s: L.AttnSpec, h, rows, tp):
    """``_attention_train``'s layout through the flash kernel: (y, k, v),
    k and v whole (every row, every head) for the cache."""
    if _heads_split(p, s):
        y, k, v = L.prefill_attention(p, s, SH.whole_in(h, rows, tp), None)
        return SH.reduce_parts(y, rows, tp), k, v
    if rows is not None:
        return L.prefill_attention(p, s, h, None)
    return L.prefill_attention_whole(p, s, h, None)


def _cross_train(p, s: L.AttnSpec, h, enc, rows, enc_rows, tp):
    """Training cross-attention on a tensor-parallel mesh: the decoder's
    rows (``rows``, or all of them) against the encoder output whole (its
    ``enc_rows`` gathered, or its copy where they do not split), on the
    rank's heads where they divide the axis (its part reduced), else all
    heads. The gathers and copies pick their gradient's reduction by
    whether the ranks' uses of the whole are parts (``gather_seq``,
    ``to_parts``) or alike (``gather_alike``, none)."""
    if _heads_split(p, s):
        y = _cross_sdpa(p, s, SH.whole_in(h, rows, tp), SH.whole_in(enc, enc_rows, tp))
        return SH.reduce_parts(y, rows, tp)
    if enc_rows is None:
        return _cross_sdpa(p, s, h, enc if rows is None else SH.to_parts(enc, tp))
    return _cross_sdpa(p, s, h, SH.gather_seq(enc, tp) if rows is not None
                       else SH.gather_alike(enc, tp))


def _mlp_part(p, s: L.MLPSpec, h, rows, tp):
    """The MLP on a tensor-parallel mesh: column- then row-parallel where
    its ffn divides the axis (h whole over the sequence, the part reduced
    in float32), else on the rows the rank holds."""
    if p["wd"].shape[0] < s.d_ff:
        return SH.reduce_parts(L.apply_mlp(p, s, SH.whole_in(h, rows, tp)), rows, tp)
    return L.apply_mlp(p, s, h)


def _cross_decode_cp(p, s: L.AttnSpec, h, ek, ev, last, tp):
    """One decoder token against a cross cache whose frames are split over
    the ranks (``cache_layout`` "slots": rank r holds frames [r T, (r+1)
    T), every head): q gathered over the heads where they are split, the
    decode kernel's partial form over the rank's frames (every one valid:
    ``last`` holds S_enc - 1), the partials merged in rank order, the
    output projection of the rank's heads (a part the caller reduces) or
    of all of them."""
    q = L._cross_q(p, s, h)
    if q.shape[2] < s.n_heads:
        q = SH.gather_model(q, tp, 2)
    T = ek.shape[1]
    merged = L.merge_over(tp, *decode_ops.decode(q[:, 0], ek.transpose(1, 2), ev.transpose(1, 2),
                                                 last, slot0=tp.rank * T, return_lse=True),
                          q.dtype)
    wo = p["wo"]
    Hl = wo.shape[0]
    if Hl < s.n_heads:
        merged = merged[:, tp.rank * Hl:(tp.rank + 1) * Hl]
    return L._out_proj(merged[:, None], wo)


def whisper_active_params(cfg: WhisperConfig) -> int:
    """The reference's count: the layers and the embedding table (once, for
    the tied unembedding product); the position table is a gather."""
    defs = whisper_param_defs(cfg)
    return count_params({k: defs[k] for k in ("enc", "dec", "embed")})


class WhisperModel(nn.Module):
    """The encoder-decoder. Parameters are drawn at construction from
    ``seed`` on ``device`` (CUDA by default; raises when there is none),
    frozen (``ParamTree``): one per layer in ``enc`` and ``dec``. Built
    with a ``mesh`` whose "model" axis is above 1 it keeps this rank's
    shard of each leaf (``param_specs``), bit for bit the same slice of
    the one-process draw, and runs only under that mesh's step context."""

    def __init__(self, cfg: WhisperConfig, device="cuda", seed: int = 0, mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh if model_size(mesh) > 1 else None
        cut = None
        if self.mesh is not None:
            if cfg.kv_heads != cfg.n_heads:
                raise NotImplementedError(
                    f"{cfg.name}: whisper on a 'model' axis above 1 takes its kv heads to be "
                    f"its heads (multi-head attention), got {cfg.kv_heads} of {cfg.n_heads}")
            stacked = whisper_param_specs(cfg, mesh, stacked=True)

            def cut(path, value):
                spec = stacked
                for k in path:
                    spec = spec[k]
                return shard(value, spec, mesh, ("model",))

        gen = torch.Generator(device=device).manual_seed(seed)
        values = init_values(self.param_defs(), gen, device, cut)
        self.embed = ParamTree(values["embed"])
        self.pos_dec = nn.Parameter(values["pos_dec"], requires_grad=False)
        self.enc = nn.ModuleList(ParamTree(p) for p in unstack(values.pop("enc"), cfg.enc_layers))
        self.dec = nn.ModuleList(ParamTree(p) for p in unstack(values.pop("dec"), cfg.dec_layers))
        self.enc_ln = ParamTree(values["enc_ln"])
        self.dec_ln = ParamTree(values["dec_ln"])

    def param_defs(self) -> Dict[str, Any]:
        return whisper_param_defs(self.cfg)

    def axes(self) -> Dict[str, Any]:
        return whisper_axes(self.cfg)

    def params(self) -> Dict[str, Any]:
        """The parameters as a tree (the module's own tensors, no copies):
        ``embed``, ``pos_dec``, ``enc_ln``, ``dec_ln`` and a list of
        per-layer dicts in ``enc`` and ``dec``."""
        out: Dict[str, Any] = {k: getattr(self, k).as_dict() for k in ("embed", "enc_ln", "dec_ln")}
        out["pos_dec"] = self.pos_dec
        out["enc"] = [p.as_dict() for p in self.enc]
        out["dec"] = [p.as_dict() for p in self.dec]
        return out

    def param_shapes(self) -> Dict[str, Any]:
        """``params()`` as meta tensors: shapes and dtypes, no storage (on a
        tensor-parallel mesh, this rank's shards)."""
        return tree_map(lambda p: torch.empty_like(p, device="meta"), self.params())

    @property
    def param_specs(self):
        """The specs of ``params()`` on the model's mesh (None without one)."""
        return None if self.mesh is None else whisper_param_specs(self.cfg, self.mesh)

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

    def _tensor_parallel(self):
        return TransformerLM._tensor_parallel(self)

    def num_params(self) -> int:
        return count_params(self.param_defs())

    def num_active_params(self) -> int:
        return whisper_active_params(self.cfg)

    def kernel_launches(self) -> Dict[str, Dict[str, int]]:
        """The kernel launches of one prefill and of one decode step on
        CUDA, by kernel wrapper: flash attention once per encoder layer and
        twice per decoder layer (self and cross) in the prefill, flash-decode
        twice per decoder layer in a decode step."""
        cfg = self.cfg
        return {"prefill": {"flash_attention": cfg.enc_layers + 2 * cfg.dec_layers},
                "decode_step": {"decode_attention": 2 * cfg.dec_layers}}

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    # -- encoder ----------------------------------------------------------------
    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, S_enc, d) -> the encoder output: the
        sinusoid added in the frames' dtype, then per layer a bidirectional
        self-attention (the flash kernel, ``causal=False``) and the MLP, each
        pre-norm residual, then ``enc_ln``. A layer norm's output takes the
        weights' dtype before its products (JAX's promotion of bfloat16
        frames against float32 weights). On a tensor-parallel mesh, the
        rank's rows of it where the frames split over the axis, else all of
        them (``_encode_tp``)."""
        tp = self._tensor_parallel()
        if tp is not None:
            return self._encode_tp(enc_embeds, tp)[0]
        cfg = self.cfg
        x = enc_embeds.to(self.device)
        B, S, D = x.shape
        x = x + _sinusoid_on(S, D, x.device, x.dtype)
        spec = _attn_spec(cfg, causal=False)
        for p in self.enc:
            h = L.layer_norm(p["ln1"], x).to(self.dtype)
            x = x + L.prefill_attention(p["attn"], spec, h, None)[0]
            h = L.layer_norm(p["ln2"], x).to(self.dtype)
            x = x + L.apply_mlp(p["mlp"], _mlp_spec(cfg), h)
        return L.layer_norm(self.enc_ln, x)

    # -- decoder blocks -------------------------------------------------------------
    def dec_block_prefill(self, p, x: torch.Tensor, enc_out: torch.Tensor, cache_len: int):
        """One decoder layer over the prompt's rows x (B, Sq, d): causal
        self-attention, cross-attention over the encoder output, MLP.
        Returns (x, the layer's cache entry: k, v in slots 0..Sq-1 of
        ``cache_len``, and the encoder's ek, ev)."""
        cfg = self.cfg
        spec = _attn_spec(cfg, causal=True)
        B, Sq = x.shape[:2]
        h = L.layer_norm(p["ln1"], x)
        y, k, v = L.prefill_attention(p["self_attn"], spec, h, None)
        x = x + y
        h = L.layer_norm(p["ln2"], x)
        ek, ev = L.cross_kv(p["cross_attn"], spec, enc_out)
        x = x + L.cross_attention(p["cross_attn"], spec, h, ek, ev)
        h = L.layer_norm(p["ln3"], x)
        x = x + L.apply_mlp(p["mlp"], _mlp_spec(cfg), h)
        kc = k.new_zeros((B, cache_len) + k.shape[2:])
        vc = torch.zeros_like(kc)
        kc[:, :Sq] = k
        vc[:, :Sq] = v
        return x, {"k": kc, "v": vc, "ek": ek, "ev": ev}

    def dec_block_decode(self, p, x: torch.Tensor, entry: dict, pos: torch.Tensor,
                         enc_last: torch.Tensor) -> torch.Tensor:
        """One decoder layer for one token x (B, 1, d) at ``pos``: the
        self-attention cache written in place at slot pos."""
        cfg = self.cfg
        spec = _attn_spec(cfg, causal=True)
        h = L.layer_norm(p["ln1"], x)
        x = x + L.decode_attention(p["self_attn"], spec, h, entry, pos)[0]
        h = L.layer_norm(p["ln2"], x)
        x = x + L.decode_cross_attention(p["cross_attn"], spec, h, entry["ek"], entry["ev"],
                                         enc_last)
        h = L.layer_norm(p["ln3"], x)
        return x + L.apply_mlp(p["mlp"], _mlp_spec(cfg), h)

    def _embed_dec(self, tokens: torch.Tensor, pos_rows: torch.Tensor) -> torch.Tensor:
        """The tokens' embeddings plus their positions' rows of ``pos_dec``
        rounded to bfloat16, as the reference adds them."""
        return L.embed(self.embed, tokens) + pos_rows.to(torch.bfloat16)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """bfloat16 logits of a float32-accumulated product with the tied
        embedding table."""
        return (L.layer_norm(self.dec_ln, x) @ self.embed.table.t()).to(torch.bfloat16)

    # -- a model axis above 1 ----------------------------------------------------------
    def _embed_tp(self, tokens, rows, tp, pos_rows):
        """Serving's token embeddings on a tensor-parallel mesh, of the
        ``rows`` the rank holds (or all): vocab-parallel where the table
        is split, else a lookup; plus ``pos_rows``' rows in bfloat16."""
        table = self.embed
        if table.table.shape[0] < self.cfg.vocab:
            x = L.embed_vocab_parallel(table, tokens, tp, seq_split=rows is not None)
        else:
            x = L.embed(table, tokens if rows is None else tokens[:, rows])
        return x + (pos_rows if rows is None else pos_rows[rows]).to(torch.bfloat16)

    def _logits_whole(self, x, tp):
        """``_logits`` with every vocab column on every rank."""
        logits = self._logits(x)
        if self.embed.table.shape[0] < self.cfg.vocab:
            logits = SH.gather_model(logits, tp, logits.dim() - 1)
        return logits

    def _encode_tp(self, enc_embeds, tp):
        """``encode`` on a tensor-parallel mesh: (the encoder output of the
        rank's rows, those rows), or (all of it, None) where the frames do
        not split over the axis. Each layer as ``_attention_prefill`` and
        ``_mlp_part`` lay it out."""
        cfg = self.cfg
        x = enc_embeds.to(self.device)
        B, S, D = x.shape
        x = x + _sinusoid_on(S, D, x.device, x.dtype)
        rows = seq_rows(S, tp)
        if rows is not None:
            x = x[:, rows]
        spec, mlp = _attn_spec(cfg, causal=False), _mlp_spec(cfg)
        for p in self.enc:
            h = L.layer_norm(p["ln1"], x).to(self.dtype)
            x = x + _attention_prefill(p["attn"], spec, h, rows, tp)[0]
            h = L.layer_norm(p["ln2"], x).to(self.dtype)
            x = x + _mlp_part(p["mlp"], mlp, h, rows, tp)
        return L.layer_norm(self.enc_ln, x), rows

    def _dec_block_prefill_tp(self, p, x, enc, cache_len: int, rows, tp):
        """``dec_block_prefill`` on a tensor-parallel mesh, over the rank's
        ``rows`` of the prompt (or all of them), ``enc`` the encoder output
        whole. Its cache entry in the decode layout (``cache_layout``): the
        rank's slots, or kv heads, of the whole self cache and of the
        encoder's ek, ev, or all of them."""
        cfg = self.cfg
        spec = _attn_spec(cfg, causal=True)
        h = L.layer_norm(p["ln1"], x)
        y, k, v = _attention_prefill(p["self_attn"], spec, h, rows, tp)
        x = x + y
        h = L.layer_norm(p["ln2"], x)
        pc = p["cross_attn"]
        ek, ev = L.cross_kv(pc, spec, enc)
        if _heads_split(pc, spec):
            y = L.cross_attention(pc, spec, SH.whole_in(h, rows, tp), ek, ev)
            x = x + SH.reduce_parts(y, rows, tp)
            ek, ev = SH.gather_model(ek, tp, 2), SH.gather_model(ev, tp, 2)  # every head
        else:
            x = x + L.cross_attention(pc, spec, h, ek, ev)
        h = L.layer_norm(p["ln3"], x)
        x = x + _mlp_part(p["mlp"], _mlp_spec(cfg), h, rows, tp)
        B, Sq = k.shape[:2]
        kc = k.new_zeros((B, cache_len) + k.shape[2:])
        vc = torch.zeros_like(kc)
        kc[:, :Sq] = k
        vc[:, :Sq] = v
        own = cache_layout(cache_len, cfg.kv_heads, tp.size)
        cross = cache_layout(ek.shape[1], cfg.kv_heads, tp.size)
        return x, {"k": SH.cut_cache(kc, own, tp), "v": SH.cut_cache(vc, own, tp),
                   "ek": SH.cut_cache(ek, cross, tp), "ev": SH.cut_cache(ev, cross, tp)}

    def _prefill_tp(self, batch, tp):
        """``prefill`` on a tensor-parallel mesh (see ``_encode_tp`` and
        ``_dec_block_prefill_tp``)."""
        tokens = batch["tokens"].to(self.device)
        enc, enc_rows = self._encode_tp(batch["enc_embeds"], tp)
        enc_len = batch["enc_embeds"].shape[1]
        if enc_rows is not None:
            enc = SH.gather_model(enc, tp, 1)
        Sq = tokens.shape[1]
        cache_len = batch.get("cache_len", Sq)
        rows = seq_rows(Sq, tp)
        x = self._embed_tp(tokens, rows, tp, self.pos_dec[:Sq])
        entries = []
        for p in self.dec:
            x, entry = self._dec_block_prefill_tp(p, x, enc, cache_len, rows, tp)
            entries.append(entry)
        last = x[:, -1:] if rows is None else SH.gather_model(x[:, -1:], tp, 1)[:, -1:]
        return self._logits_whole(last, tp), {"dec": entries, "enc_last": self._enc_last(enc_len)}

    def _dec_block_decode_tp(self, p, x, entry, pos, enc_last, layouts, tp):
        """``dec_block_decode`` on a tensor-parallel mesh, the token whole on
        every rank. Self-attention context-parallel over the rank's slots
        (``layers._decode_attention_cp``) where the self cache is split by
        slots, else over the rank's kv heads, or all of them
        (``layers.decode_attention_local``); cross-attention likewise
        (``_cross_decode_cp``, ``layers.decode_cross_attention``). Each
        part of split heads or ffn columns summed over "model" in float32
        and cast once."""
        cfg = self.cfg
        spec = _attn_spec(cfg, causal=True)
        own, cross = layouts
        h = L.layer_norm(p["ln1"], x)
        ps, pc = p["self_attn"], p["cross_attn"]
        if own == "slots":
            y, _ = L._decode_attention_cp(ps, spec, h, entry, pos, tp, tp)
        else:
            y, _ = L.decode_attention_local(ps, spec, h, entry, pos)
        x = x + (SH.reduce_parts(y, None, tp) if _heads_split(ps, spec) else y)
        h = L.layer_norm(p["ln2"], x)
        if cross == "slots":
            y = _cross_decode_cp(pc, spec, h, entry["ek"], entry["ev"], enc_last, tp)
        else:
            y = L.decode_cross_attention(pc, spec, h, entry["ek"], entry["ev"], enc_last)
        x = x + (SH.reduce_parts(y, None, tp) if _heads_split(pc, spec) else y)
        h = L.layer_norm(p["ln3"], x)
        return x + _mlp_part(p["mlp"], _mlp_spec(cfg), h, None, tp)

    def _decode_step_tp(self, cache, batch, tp):
        """``decode_step`` on a tensor-parallel mesh. The batch's host ints
        ``cache_len`` and ``enc_len`` are the whole self and cross caches'
        slots, which decide their layouts (``cache_layout``): a rank's
        cache alone does not say whether it is a share or the whole."""
        missing = [k for k in ("cache_len", "enc_len") if k not in batch]
        if missing:
            raise ValueError(f"whisper's decode on a 'model' axis above 1 needs the whole "
                             f"caches' sizes as batch[{missing}] (build_decode_step passes its "
                             f"shape's)")
        cfg = self.cfg
        token = batch["token"].to(self.device)
        pos = torch.as_tensor(batch["pos"], dtype=torch.int32, device=self.device)
        x = self._embed_tp(token, None, tp, self.pos_dec.index_select(0, pos.reshape(1).long()))
        layouts = (cache_layout(int(batch["cache_len"]), cfg.kv_heads, tp.size),
                   cache_layout(int(batch["enc_len"]), cfg.kv_heads, tp.size))
        for p, entry in zip(self.dec, cache["dec"]):
            x = self._dec_block_decode_tp(p, x, entry, pos, cache["enc_last"], layouts, tp)
        return self._logits_whole(x, tp), cache

    # -- serving ---------------------------------------------------------------------
    def cache_defs(self, batch: int, cache_len: int, enc_len: int, dtype=None) -> Dict[str, Any]:
        """The cache's declaration in the port's layout (the reference's
        ``cache_defs`` with its ``dec`` layers unstacked): per decoder layer
        k, v (B, cache_len, KV, hd) and ek, ev (B, enc_len, KV, hd) in
        ``dtype`` (the model's by default), and the 0-d int32 ``enc_last``
        (``init_cache`` sets it to enc_len - 1)."""
        dtype = dtype or self.dtype
        cfg = self.cfg
        axes = ("batch", "kv_seq", "kv_heads", None)

        def kv(n):
            return ParamDef((batch, n, cfg.kv_heads, cfg.head_dim), axes, init="zeros",
                            dtype=dtype)

        return {"dec": [{"k": kv(cache_len), "v": kv(cache_len), "ek": kv(enc_len),
                         "ev": kv(enc_len)} for _ in range(cfg.dec_layers)],
                "enc_last": ParamDef((), (), init="zeros", dtype=torch.int32)}

    def init_cache(self, batch: int, cache_len: int, enc_len: int, dtype=None):
        """A zero cache of ``cache_defs`` on the model's device, ``enc_last``
        holding enc_len - 1."""
        defs = self.cache_defs(batch, cache_len, enc_len, dtype)
        dec = [{n: torch.zeros(d.shape, dtype=d.dtype, device=self.device)
                for n, d in layer.items()} for layer in defs["dec"]]
        return {"dec": dec, "enc_last": self._enc_last(enc_len)}

    def _enc_last(self, enc_len: int) -> torch.Tensor:
        return torch.tensor(enc_len - 1, dtype=torch.int32, device=self.device)

    @torch.no_grad()
    def prefill(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encode, then run the decoder prompt. batch: tokens (B, Sq) int,
        enc_embeds (B, S_enc, d), optional cache_len (default Sq). Returns
        (last-token logits (B, 1, V) bf16, cache). On a tensor-parallel
        mesh, ``_prefill_tp``."""
        tp = self._tensor_parallel()
        if tp is not None:
            return self._prefill_tp(batch, tp)
        tokens = batch["tokens"].to(self.device)
        enc_out = self.encode(batch["enc_embeds"])
        Sq = tokens.shape[1]
        cache_len = batch.get("cache_len", Sq)
        x = self._embed_dec(tokens, self.pos_dec[:Sq])
        entries = []
        for p in self.dec:
            x, entry = self.dec_block_prefill(p, x, enc_out, cache_len)
            entries.append(entry)
        return self._logits(x[:, -1:]), {"dec": entries,
                                         "enc_last": self._enc_last(enc_out.shape[1])}

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One new token. batch: token (B, 1) int, pos () int32 (a 0-d tensor
        on the model's device, or an int): the decoder tokens already
        cached, and the row of ``pos_dec`` (read on the device). Writes the
        self-attention caches IN PLACE and returns (logits (B, 1, V) bf16,
        cache). On a tensor-parallel mesh, ``_decode_step_tp``."""
        tp = self._tensor_parallel()
        if tp is not None:
            return self._decode_step_tp(cache, batch, tp)
        token = batch["token"].to(self.device)
        pos = torch.as_tensor(batch["pos"], dtype=torch.int32, device=self.device)
        x = self._embed_dec(token, self.pos_dec.index_select(0, pos.reshape(1).long()))
        for p, entry in zip(self.dec, cache["dec"]):
            x = self.dec_block_decode(p, x, entry, pos, cache["enc_last"])
        return self._logits(x), cache

    # -- training --------------------------------------------------------------------
    def _layer(self, fn, x, p):
        """``fn(x, p)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
        (its activations recomputed in the backward pass, under the
        forward's sharding context)."""
        if not self.cfg.remat:
            return fn(x, p)
        return checkpoint(fn, x, p, use_reentrant=False, context_fn=remat_context)

    def train_encode(self, params, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder's training forward (the reference's ``encode``) over
        ``params``, differentiable: the sinusoid added in the frames' dtype,
        then per layer ``ln1``, bidirectional plain attention, ``ln2`` and
        the MLP, each pre-norm residual, then ``enc_ln``. A layer norm's
        output takes the weights' dtype before its products, as ``encode``.
        On a tensor-parallel mesh, ``_train_encode_tp``."""
        tp = SH.tensor_parallel()
        if tp is not None:
            return self._train_encode_tp(params, enc_embeds, tp)
        cfg = self.cfg
        x = enc_embeds.to(self.device)
        B, S, D = x.shape
        x = shard_act(x + _sinusoid_on(S, D, x.device, x.dtype), ("batch", "act_seq", "embed"))
        spec, mlp = _attn_spec(cfg, causal=False), _mlp_spec(cfg)
        wdtype = params["embed"]["table"].dtype

        def layer(x, p):
            p = gather_stored(p)  # fsdp: this layer's leaves whole, in its checkpoint
            h = L.layer_norm(p["ln1"], x).to(wdtype)
            x = x + L.apply_attention(p["attn"], spec, h, None)
            h = L.layer_norm(p["ln2"], x).to(wdtype)
            return shard_act(x + L.apply_mlp(p["mlp"], mlp, h), ("batch", "act_seq", "embed"))

        for p in params["enc"]:
            x = self._layer(layer, x, p)
        return L.layer_norm(gather_stored(params["enc_ln"]), x)

    def decode_stack(self, params, tokens: torch.Tensor, enc_out: torch.Tensor,
                     enc_len: Optional[int] = None) -> torch.Tensor:
        """The decoder's training forward with teacher forcing (the
        reference's ``decode_stack``) over ``params``: the tokens'
        embeddings plus ``pos_dec``'s rows 0..S-1 rounded to bfloat16, per
        layer causal self-attention, cross-attention of every row over every
        encoder frame (the encoder's keys and values with their biases,
        ``_sdpa`` with no mask) and the MLP, each pre-norm residual, then
        ``dec_ln``. On a tensor-parallel mesh, ``_decode_stack_tp`` (with
        ``enc_len``, the encoder's whole length: ``enc_out`` is its rows
        where they split)."""
        tp = SH.tensor_parallel()
        if tp is not None:
            return self._decode_stack_tp(params, tokens, enc_out, enc_len, tp)
        cfg = self.cfg
        S = tokens.shape[1]
        top = gather_stored({"embed": params["embed"], "pos_dec": params["pos_dec"]})
        x = L.embed(top["embed"], tokens) + _pos_bf16(top["pos_dec"][:S])
        x = shard_act(x, ("batch", "act_seq", "embed"))
        spec, mlp = _attn_spec(cfg, causal=True), _mlp_spec(cfg)

        def layer(x, p):
            p = gather_stored(p)
            h = L.layer_norm(p["ln1"], x)
            x = x + L.apply_attention(p["self_attn"], spec, h, None)
            h = L.layer_norm(p["ln2"], x)
            x = x + _cross_sdpa(p["cross_attn"], spec, h, enc_out)
            h = L.layer_norm(p["ln3"], x)
            return shard_act(x + L.apply_mlp(p["mlp"], mlp, h), ("batch", "act_seq", "embed"))

        for p in params["dec"]:
            x = self._layer(layer, x, p)
        return L.layer_norm(gather_stored(params["dec_ln"]), x)

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy of the decoder over the encoded frames
        (the reference's ``loss``). batch: tokens (B, S) int and enc_embeds
        (B, S_enc, d). Returns (per_example_loss (B,) float32, {}),
        differentiable in ``params`` (a tree as ``params()`` gives): tied
        logits of a float32-accumulated product rounded to bfloat16, the CE
        in float32 on ``tokens[:, 1:]``, averaged per example. On a
        tensor-parallel mesh, ``_loss_tp``."""
        tokens = batch["tokens"].to(self.device).long()
        tp = self._tensor_parallel()
        if tp is not None:
            return self._loss_tp(params, tokens, batch["enc_embeds"], tp), {}
        x = self.decode_stack(params, tokens, self.train_encode(params, batch["enc_embeds"]))
        table = gather_stored(params["embed"])["table"]  # the tied table's second use
        return _sharded_ce(_tied_logits(x[:, :-1], table), tokens[:, 1:]).mean(dim=-1), {}

    # -- training on a model axis above 1 ---------------------------------------------
    #
    # A sequence that splits over the axis is held as each rank's rows (each
    # rank's gradients its own rows' share); one that does not is whole on
    # every rank, which computes it alike: there a leaf "model" does not
    # split is marked to keep its gradient on rank 0 only (``SH.once_whole``),
    # since the train step sums such leaves' gradients over the axis, and an
    # input entering the ranks' parts of split heads or ffn columns takes
    # ``SH.to_parts`` (its gradient, partial on each rank, summed).

    def _train_encode_tp(self, params, enc_embeds, tp):
        """``train_encode`` on a tensor-parallel mesh: the encoder output of
        the rank's rows, or all of it where the frames do not split."""
        cfg = self.cfg
        x = enc_embeds.to(self.device)
        B, S, D = x.shape
        x = x + _sinusoid_on(S, D, x.device, x.dtype)
        rows = seq_rows(S, tp)
        if rows is not None:
            x = x[:, rows]
        spec, mlp, defs = _attn_spec(cfg, causal=False), _mlp_spec(cfg), _enc_layer_defs(cfg)
        wdtype = params["embed"]["table"].dtype

        def layer(x, p):
            p = gather_stored(p)
            if rows is None:
                p = SH.once_whole(p, defs, tp)
            h = L.layer_norm(p["ln1"], x).to(wdtype)
            x = x + _attention_train(p["attn"], spec, h, rows, tp)
            h = L.layer_norm(p["ln2"], x).to(wdtype)
            return x + _mlp_part(p["mlp"], mlp, h, rows, tp)

        for p in params["enc"]:
            x = self._layer(layer, x, p)
        return L.layer_norm(self._norm_tp(params["enc_ln"], rows, tp), x)

    def _norm_tp(self, p, rows, tp):
        """A final layer norm's leaves: gathered under fsdp, and marked
        ``SH.once_whole`` where the sequence does not split."""
        p = gather_stored(p)
        return p if rows is not None else SH.once_whole(p, L.init_layernorm(self.cfg.d_model), tp)

    def _decode_stack_tp(self, params, tokens, enc_out, enc_len, tp):
        """``decode_stack`` on a tensor-parallel mesh: the decoder's output of
        the rank's rows, or all of it where the tokens do not split."""
        if enc_len is None:
            raise ValueError("decode_stack on a 'model' axis above 1 needs enc_len, the "
                             "encoder's whole length")
        cfg = self.cfg
        S = tokens.shape[1]
        rows, enc_rows = seq_rows(S, tp), seq_rows(enc_len, tp)
        top = gather_stored({"embed": params["embed"], "pos_dec": params["pos_dec"]})
        table, pos = top["embed"], top["pos_dec"][:S]
        if table["table"].shape[0] < cfg.vocab:
            x = L.embed_vocab_parallel(table, tokens, tp, seq_split=rows is not None)
        elif rows is None:
            x = L.embed({"table": SH.once_over_model(table["table"], tp)}, tokens)
        else:
            x = L.embed(table, tokens[:, rows])
        pos = SH.once_over_model(pos, tp) if rows is None else pos[rows]
        x = x + _pos_bf16(pos)
        spec, mlp, defs = _attn_spec(cfg, causal=True), _mlp_spec(cfg), _dec_layer_defs(cfg)

        def layer(x, p):
            p = gather_stored(p)
            if rows is None:
                p = SH.once_whole(p, defs, tp)
            h = L.layer_norm(p["ln1"], x)
            x = x + _attention_train(p["self_attn"], spec, h, rows, tp)
            h = L.layer_norm(p["ln2"], x)
            x = x + _cross_train(p["cross_attn"], spec, h, enc_out, rows, enc_rows, tp)
            h = L.layer_norm(p["ln3"], x)
            return x + _mlp_part(p["mlp"], mlp, h, rows, tp)

        for p in params["dec"]:
            x = self._layer(layer, x, p)
        return L.layer_norm(self._norm_tp(params["dec_ln"], rows, tp), x)

    def _loss_tp(self, params, tokens, enc_embeds, tp):
        """``loss`` on a tensor-parallel mesh, the whole loss on every rank:
        with the vocab split, the decoder's rows whole and the
        vocab-parallel CE; else each rank's rows' logits against the whole
        table and their targets one token on (across the ranks' row
        boundaries), the NLL summed over "model"; or, where the tokens do
        not split, every rank's alike."""
        S = tokens.shape[1]
        x = self.decode_stack(params, tokens, self.train_encode(params, enc_embeds),
                              enc_len=enc_embeds.shape[1])
        rows = seq_rows(S, tp)
        table = gather_stored(params["embed"])["table"]  # the tied table's second use
        if table.shape[0] < self.cfg.vocab:
            logits = _tied_logits(SH.whole_in(x, rows, tp)[:, :-1], table)
            return _vocab_parallel_ce(logits, tokens[:, 1:], tp.rank * table.shape[0],
                                      tp).mean(dim=-1)
        if rows is None:
            logits = _tied_logits(x[:, :-1], SH.once_over_model(table, tp))
            return _sharded_ce(logits, tokens[:, 1:]).mean(dim=-1)
        tgt = tokens[:, rows.start + 1:rows.stop + 1]
        nll = _sharded_ce(_tied_logits(x[:, :tgt.shape[1]], table), tgt)
        return SH.sum_model(nll.sum(dim=-1), tp) / (S - 1)
