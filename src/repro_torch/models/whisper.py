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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
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
from repro_torch.models.sharding_hooks import gather_stored, remat_context, shard_act
from repro_torch.models.transformer import _sharded_ce
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


def whisper_active_params(cfg: WhisperConfig) -> int:
    """The reference's count: the layers and the embedding table (once, for
    the tied unembedding product); the position table is a gather."""
    defs = whisper_param_defs(cfg)
    return count_params({k: defs[k] for k in ("enc", "dec", "embed")})


class WhisperModel(nn.Module):
    """The encoder-decoder. Parameters are drawn at construction from
    ``seed`` on ``device`` (CUDA by default; raises when there is none),
    frozen (``ParamTree``): one per layer in ``enc`` and ``dec``."""

    def __init__(self, cfg: WhisperConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        values = init_values(self.param_defs(), gen, device)
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
        """``params()`` as meta tensors: shapes and dtypes, no storage."""
        return tree_map(lambda p: torch.empty_like(p, device="meta"), self.params())

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
        frames against float32 weights)."""
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
        (last-token logits (B, 1, V) bf16, cache)."""
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
        cache)."""
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
        output takes the weights' dtype before its products, as ``encode``."""
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

    def decode_stack(self, params, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """The decoder's training forward with teacher forcing (the
        reference's ``decode_stack``) over ``params``: the tokens'
        embeddings plus ``pos_dec``'s rows 0..S-1 rounded to bfloat16, per
        layer causal self-attention, cross-attention of every row over every
        encoder frame (the encoder's keys and values with their biases,
        ``_sdpa`` with no mask) and the MLP, each pre-norm residual, then
        ``dec_ln``."""
        cfg = self.cfg
        S = tokens.shape[1]
        top = gather_stored({"embed": params["embed"], "pos_dec": params["pos_dec"]})
        x = L.embed(top["embed"], tokens) + top["pos_dec"][:S].to(torch.bfloat16)
        x = shard_act(x, ("batch", "act_seq", "embed"))
        spec, mlp = _attn_spec(cfg, causal=True), _mlp_spec(cfg)

        def layer(x, p):
            p = gather_stored(p)
            h = L.layer_norm(p["ln1"], x)
            x = x + L.apply_attention(p["self_attn"], spec, h, None)
            h = L.layer_norm(p["ln2"], x)
            ek, ev = L.cross_kv(p["cross_attn"], spec, enc_out)
            with L._span("sdpa"):
                out = L._sdpa(L._cross_q(p["cross_attn"], spec, h), ek, ev, None,
                              spec.n_heads // spec.kv_heads)
            x = x + L._out_proj(out, p["cross_attn"]["wo"])
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
        in float32 on ``tokens[:, 1:]``, averaged per example."""
        tokens = batch["tokens"].to(self.device).long()
        x = self.decode_stack(params, tokens, self.train_encode(params, batch["enc_embeds"]))
        table = gather_stored(params["embed"])["table"]  # the tied table's second use
        logits = (x[:, :-1] @ table.t()).to(torch.bfloat16)
        return _sharded_ce(logits, tokens[:, 1:]).mean(dim=-1), {}
