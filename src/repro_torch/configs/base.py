"""Config helpers shared by the per-architecture files.

Port of the reference's ``configs/base.py``: ``attn_block``, ``mlp_block``,
``moe_block``, ``mamba2_block``, ``rwkv6_blocks`` and ``dense_lm``.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import ArchConfig, BlockSpec, GroupSpec


def attn_block(
    d_model: int,
    n_heads: int,
    kv_heads: int,
    head_dim: int,
    window: Optional[int] = None,
    rope: str = "std",
    rope_theta: float = 10000.0,
    qk_norm: bool = False,
    bias: bool = False,
    mrope_sections: Tuple[int, int, int] = (16, 24, 24),
) -> BlockSpec:
    return BlockSpec(
        kind="attn",
        attn=L.AttnSpec(
            d_model=d_model,
            n_heads=n_heads,
            kv_heads=kv_heads,
            head_dim=head_dim,
            window=window,
            rope=rope,
            rope_theta=rope_theta,
            qk_norm=qk_norm,
            bias=bias,
            mrope_sections=mrope_sections,
        ),
    )


def mlp_block(d_model: int, d_ff: int, activation: str = "silu", gated: bool = True) -> BlockSpec:
    return BlockSpec(kind="mlp", mlp=L.MLPSpec(d_model, d_ff, activation, gated))


def moe_block(
    d_model: int,
    d_expert: int,
    num_experts: int,
    top_k: int,
    num_shared: int = 0,
    d_shared: int = 0,
    capacity_factor: float = 1.25,
) -> BlockSpec:
    return BlockSpec(
        kind="moe",
        moe=L.MoESpec(
            d_model=d_model,
            d_expert=d_expert,
            num_experts=num_experts,
            top_k=top_k,
            num_shared=num_shared,
            d_shared=d_shared,
            capacity_factor=capacity_factor,
        ),
    )


def mamba2_block(d_model: int, d_state: int = 64, chunk: int = 128) -> BlockSpec:
    return BlockSpec(kind="mamba2", mamba=S.Mamba2Spec(d_model=d_model, d_state=d_state, chunk=chunk))


def rwkv6_blocks(d_model: int, d_ff: int, chunk: int = 64) -> Tuple[BlockSpec, BlockSpec]:
    spec = S.RWKV6Spec(d_model=d_model, chunk=chunk)
    return (
        BlockSpec(kind="rwkv6_time", rwkv=spec),
        BlockSpec(kind="rwkv6_channel", rwkv=spec, rwkv_ffn=d_ff),
    )


def dense_lm(
    name: str,
    n_layers: int,
    d_model: int,
    n_heads: int,
    kv_heads: int,
    d_ff: int,
    vocab: int,
    head_dim: Optional[int] = None,
    activation: str = "silu",
    gated: bool = True,
    rope_theta: float = 10000.0,
    tie_embeddings: bool = False,
    qk_norm: bool = False,
    bias: bool = False,
    mrope: bool = False,
    mrope_sections: Tuple[int, int, int] = (16, 24, 24),
) -> ArchConfig:
    hd = head_dim or d_model // n_heads
    layer = (
        attn_block(
            d_model, n_heads, kv_heads, hd,
            rope="mrope" if mrope else "std",
            rope_theta=rope_theta, qk_norm=qk_norm, bias=bias,
            mrope_sections=mrope_sections,
        ),
        mlp_block(d_model, d_ff, activation, gated),
    )
    return ArchConfig(
        name=name,
        vocab=vocab,
        d_model=d_model,
        groups=(GroupSpec(blocks=layer, repeat=n_layers),),
        tie_embeddings=tie_embeddings,
        mrope=mrope,
    )
