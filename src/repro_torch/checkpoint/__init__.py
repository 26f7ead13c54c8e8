"""Atomic, asynchronous, keep-K checkpoints in the reference's on-disk
format (the port of ``src/repro/checkpoint``)."""
from repro_torch.checkpoint.ckpt import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
