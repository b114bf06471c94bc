"""Checkpointing: atomic numpy-file snapshots, async save, restore."""

from .checkpoint import (CheckpointManager, latest_step, list_steps,
                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "list_steps"]
