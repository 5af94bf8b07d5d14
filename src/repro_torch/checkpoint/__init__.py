"""Checkpoints in the reference's layout (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]
