"""minitron-4b [arXiv:2407.14679]: pruned Nemotron. 32L, d_model 3072,
24 heads / 8 kv (GQA), head_dim 128, d_ff 9216 with squared-ReLU (non-gated,
the Nemotron recipe), vocab 256000, untied embeddings."""
from repro_torch.configs.base import dense_lm
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return dense_lm(
        "minitron-4b",
        n_layers=32, d_model=3072, n_heads=24, kv_heads=8, d_ff=9216,
        vocab=256000, head_dim=128, activation="relu2", gated=False,
        rope_theta=10000.0, tie_embeddings=False,
    )


def reduced() -> ArchConfig:
    return dense_lm(
        "minitron-reduced",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=256, head_dim=16, activation="relu2", gated=False,
    )
