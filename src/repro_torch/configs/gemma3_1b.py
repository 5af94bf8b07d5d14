"""gemma3-1b [hf:google/gemma-3-1b-pt]: 26L, d_model 1152, 4 q heads / 1 kv
head (MQA), head_dim 256, d_ff 6912 (GeGLU), vocab 262144. 5:1
local(sliding-512):global layer pattern; local layers rope theta 10k, global
1M (128k context recipe). Tied embeddings, embed scaling, qk-norm."""
from repro_torch.configs.base import attn_block, mlp_block
from repro_torch.models.transformer import ArchConfig, GroupSpec

D, H, KV, HD, FF, V = 1152, 4, 1, 256, 6912, 262144
WINDOW = 512


def _layer(local: bool, d=D, h=H, kv=KV, hd=HD, ff=FF, window=WINDOW):
    attn = attn_block(
        d, h, kv, hd,
        window=window if local else None,
        rope_theta=10000.0 if local else 1000000.0,
        qk_norm=True,
    )
    return (attn, mlp_block(d, ff, "gelu"))


def config() -> ArchConfig:
    blocks = ()
    for _ in range(5):
        blocks += _layer(True)
    blocks += _layer(False)
    tail = _layer(True) + _layer(True)
    return ArchConfig(
        name="gemma3-1b",
        vocab=V,
        d_model=D,
        groups=(
            GroupSpec(blocks=blocks, repeat=4),   # 4 x (5 local + 1 global) = 24
            GroupSpec(blocks=tail, repeat=1),     # + 2 local = 26 layers
        ),
        tie_embeddings=True,
        embed_scale=True,
        subquadratic=True,  # local layers dominate; global-layer decode is O(S)
    )


def reduced() -> ArchConfig:
    """Smoke-test config: same family (5:1 local:global, MQA, tied, scaled)."""
    d, h, kv, hd, ff, v, w = 64, 4, 1, 16, 128, 256, 8
    blocks = ()
    for _ in range(2):
        blocks += (
            attn_block(d, h, kv, hd, window=w, qk_norm=True),
            mlp_block(d, ff, "gelu"),
        )
    blocks += (attn_block(d, h, kv, hd, qk_norm=True), mlp_block(d, ff, "gelu"))
    return ArchConfig(
        name="gemma3-reduced",
        vocab=v,
        d_model=d,
        groups=(GroupSpec(blocks=blocks, repeat=2),),
        tie_embeddings=True,
        embed_scale=True,
        subquadratic=True,
    )
