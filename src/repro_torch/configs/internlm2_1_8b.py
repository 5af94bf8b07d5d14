"""internlm2-1.8b [arXiv:2403.17297]: 24L, d_model 2048, 16 heads / 8 kv
(GQA), head_dim 128, d_ff 8192 (SwiGLU), vocab 92544, rope theta 1e6."""
from repro_torch.configs.base import dense_lm
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return dense_lm(
        "internlm2-1.8b",
        n_layers=24, d_model=2048, n_heads=16, kv_heads=8, d_ff=8192,
        vocab=92544, head_dim=128, activation="silu",
        rope_theta=1000000.0, tie_embeddings=False,
    )


def reduced() -> ArchConfig:
    return dense_lm(
        "internlm2-reduced",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=256, head_dim=16,
    )
