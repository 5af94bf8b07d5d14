"""Optimizers and learning-rate schedules (port of the reference's
``optim/``)."""
from repro_torch.optim.optimizers import (
    AdamLeaf,
    Optimizer,
    OptState,
    adam,
    adamw,
    chain_clip,
    clip_by_global_norm,
    global_norm,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup

__all__ = [
    "AdamLeaf",
    "Optimizer",
    "OptState",
    "sgd",
    "momentum",
    "adam",
    "adamw",
    "global_norm",
    "clip_by_global_norm",
    "chain_clip",
    "constant",
    "cosine_warmup",
    "linear_warmup",
]
