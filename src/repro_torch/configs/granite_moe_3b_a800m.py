"""granite-moe-3b-a800m [hf:ibm-granite]: 32L, d_model 1536, 24 heads / 8 kv
(GQA, head_dim 64), MoE: 40 experts, top-8, d_expert 512 (SwiGLU), vocab
49155, tied embeddings.

Sharding note (the reference's): 40 experts do not divide its 16-way model
axis, so experts are replicated and the expert ffn dim (512 = 16 x 32) is
tensor-parallel instead, set through ``sharding_overrides``."""
from repro_torch.configs.base import attn_block, moe_block
from repro_torch.models.transformer import ArchConfig, GroupSpec

D, H, KV, HD, V = 1536, 24, 8, 64, 49155
E, K, DE = 40, 8, 512


def config() -> ArchConfig:
    layer = (
        attn_block(D, H, KV, HD),
        moe_block(D, DE, E, K, capacity_factor=1.25),
    )
    return ArchConfig(
        name="granite-moe-3b-a800m",
        vocab=V,
        d_model=D,
        groups=(GroupSpec(blocks=layer, repeat=32),),
        tie_embeddings=True,
        sharding_overrides={"experts": None, "expert_ffn": "model"},
    )


def reduced() -> ArchConfig:
    layer = (
        attn_block(64, 4, 2, 16),
        moe_block(64, 32, 8, 2, capacity_factor=2.0),
    )
    return ArchConfig(
        name="granite-moe-reduced",
        vocab=256,
        d_model=64,
        groups=(GroupSpec(blocks=layer, repeat=2),),
        tie_embeddings=True,
        sharding_overrides={"experts": None, "expert_ffn": "model"},
    )
