"""zamba2-1.2b [arXiv:2411.15242]: 38 Mamba2 layers (d_model 2048, ssm_state
64, head_dim 64) + ONE shared attention(32H, MHA)+MLP(8192) block applied
every 6 Mamba layers with shared weights (the Zamba recipe), vocab 32000,
tied embeddings. Hybrid => subquadratic, runs long_500k."""
from repro_torch.configs.base import attn_block, mamba2_block, mlp_block
from repro_torch.models.transformer import ArchConfig, GroupSpec

D, V = 2048, 32000


def config() -> ArchConfig:
    mamba = mamba2_block(D, d_state=64)
    shared = (attn_block(D, 32, 32, 64), mlp_block(D, 8192))
    return ArchConfig(
        name="zamba2-1.2b",
        vocab=V,
        d_model=D,
        groups=(
            GroupSpec(blocks=(mamba,) * 6, repeat=6, shared=shared),  # 36 mamba + 6 shared apps
            GroupSpec(blocks=(mamba, mamba), repeat=1),               # 38 total mamba layers
        ),
        tie_embeddings=True,
        subquadratic=True,
    )


def reduced() -> ArchConfig:
    mamba = mamba2_block(64, d_state=16, chunk=16)
    shared = (attn_block(64, 4, 4, 16), mlp_block(64, 128))
    return ArchConfig(
        name="zamba2-reduced",
        vocab=256,
        d_model=64,
        groups=(
            GroupSpec(blocks=(mamba,) * 2, repeat=2, shared=shared),
            GroupSpec(blocks=(mamba,), repeat=1),
        ),
        tie_embeddings=True,
        subquadratic=True,
    )
