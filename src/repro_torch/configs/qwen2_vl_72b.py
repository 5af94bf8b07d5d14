"""qwen2-vl-72b [arXiv:2409.12191]: 80L, d_model 8192, 64 heads / 8 kv (GQA,
head_dim 128), d_ff 29568 (SwiGLU), vocab 152064, M-RoPE (sections 16/24/24
freq pairs for t/h/w), qkv bias, untied embeddings. The vision frontend is a
stub, as in the reference: the inputs are token ids and precomputed (3, B, S)
M-RoPE position ids."""
from repro_torch.configs.base import dense_lm
from repro_torch.models.transformer import ArchConfig


def config() -> ArchConfig:
    return dense_lm(
        "qwen2-vl-72b",
        n_layers=80, d_model=8192, n_heads=64, kv_heads=8, d_ff=29568,
        vocab=152064, head_dim=128, activation="silu",
        rope_theta=1000000.0, tie_embeddings=False, bias=True, mrope=True,
    )


def reduced() -> ArchConfig:
    return dense_lm(
        "qwen2-vl-reduced",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=256, head_dim=16, bias=True, mrope=True, mrope_sections=(2, 3, 3),
    )
