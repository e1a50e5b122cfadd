"""Checkpointing of the port (single process): atomic, CRC-checked,
async, keep-K, in the reference's on-disk format."""
from repro_torch.checkpoint.manager import CheckpointManager, latest_step, restore, save

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
