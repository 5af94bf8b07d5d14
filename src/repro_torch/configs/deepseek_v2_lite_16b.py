"""deepseek-v2-lite-16b [arXiv:2405.04434]: 27L, d_model 2048, 16 heads with
MLA (kv_lora 512, qk_nope 128, qk_rope 64, v_head 128). Layer 0 is dense
(d_ff 10944); layers 1-26 are MoE: 64 routed experts top-6 + 2 shared
experts, d_expert 1408 (SwiGLU). vocab 102400."""
from repro_torch.configs.base import mlp_block, moe_block
from repro_torch.models import layers as L
from repro_torch.models.transformer import ArchConfig, BlockSpec, GroupSpec

D, H, V = 2048, 16, 102400
KV_LORA, QK_NOPE, QK_ROPE, V_HEAD = 512, 128, 64, 128
E, K, DE = 64, 6, 1408


def mla_block(d=D, h=H) -> BlockSpec:
    return BlockSpec(
        kind="mla",
        mla=L.MLASpec(
            d_model=d, n_heads=h, kv_lora=KV_LORA,
            qk_nope=QK_NOPE, qk_rope=QK_ROPE, v_head=V_HEAD,
        ),
    )


def config() -> ArchConfig:
    dense_layer = (mla_block(), mlp_block(D, 10944))
    moe_layer = (
        mla_block(),
        moe_block(D, DE, E, K, num_shared=2, d_shared=2 * DE, capacity_factor=1.25),
    )
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        vocab=V,
        d_model=D,
        groups=(
            GroupSpec(blocks=dense_layer, repeat=1),
            GroupSpec(blocks=moe_layer, repeat=26),
        ),
        tie_embeddings=False,
    )


def reduced() -> ArchConfig:
    mla = BlockSpec(
        kind="mla",
        mla=L.MLASpec(d_model=64, n_heads=4, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16),
    )
    dense_layer = (mla, mlp_block(64, 128))
    moe_layer = (mla, moe_block(64, 32, 8, 2, num_shared=2, d_shared=64, capacity_factor=2.0))
    return ArchConfig(
        name="deepseek-v2-lite-reduced",
        vocab=256,
        d_model=64,
        groups=(
            GroupSpec(blocks=dense_layer, repeat=1),
            GroupSpec(blocks=moe_layer, repeat=2),
        ),
    )
