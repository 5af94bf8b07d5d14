"""phi4-mini-3.8b [arXiv:2412.08905]: 32L, d_model 3072, 24 heads / 8 kv
(GQA), head_dim 128, d_ff 8192 (SwiGLU), vocab 200064, tied embeddings."""
from repro_torch.configs.base import dense_lm
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return dense_lm(
        "phi4-mini-3.8b",
        n_layers=32, d_model=3072, n_heads=24, kv_heads=8, d_ff=8192,
        vocab=200064, head_dim=128, activation="silu",
        rope_theta=10000.0, tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return dense_lm(
        "phi4-mini-reduced",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=256, head_dim=16, tie_embeddings=True,
    )
