"""rwkv6-7b "Finch" [arXiv:2404.05892]: 32L, d_model 4096 (64 heads of 64),
attention-free data-dependent-decay linear recurrence (time mix) + squared-
ReLU channel mix with d_ff 14336, vocab 65536, untied. Fully sub-quadratic:
an O(1)-per-token state."""
from repro_torch.configs.base import rwkv6_blocks
from repro_torch.models.transformer import ArchConfig, GroupSpec


def config() -> ArchConfig:
    # chunk=16, the reference's value: it sizes the CPU path's chunked scan
    # (its pairwise-decay tensor); the CUDA kernel runs the step form
    time_mix, channel_mix = rwkv6_blocks(4096, 14336, chunk=16)
    return ArchConfig(
        name="rwkv6-7b",
        vocab=65536,
        d_model=4096,
        groups=(GroupSpec(blocks=(time_mix, channel_mix), repeat=32),),
        tie_embeddings=False,
        subquadratic=True,
    )


def reduced() -> ArchConfig:
    time_mix, channel_mix = rwkv6_blocks(64, 128, chunk=8)
    return ArchConfig(
        name="rwkv6-reduced",
        vocab=256,
        d_model=64,
        groups=(GroupSpec(blocks=(time_mix, channel_mix), repeat=2),),
        subquadratic=True,
    )
