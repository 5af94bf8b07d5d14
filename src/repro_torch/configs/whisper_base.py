"""whisper-base [arXiv:2212.04356]: 6L encoder + 6L decoder, d_model 512,
8 heads (MHA), d_ff 2048 (GELU), vocab 51865. The convolutional frontend is
a stub, as in the reference: the encoder takes precomputed frame embeddings
(B, S_enc, d_model)."""
from repro_torch.models.whisper import WhisperConfig


def config() -> WhisperConfig:
    return WhisperConfig(
        name="whisper-base",
        vocab=51865, d_model=512, n_heads=8, kv_heads=8, d_ff=2048,
        enc_layers=6, dec_layers=6, max_positions=65536,
    )


def reduced() -> WhisperConfig:
    return WhisperConfig(
        name="whisper-reduced",
        vocab=256, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        enc_layers=2, dec_layers=2, max_positions=128,
    )
