"""Checkpoints in the reference's format (the port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
