"""Checkpointing of the port: atomic, CRC-checked, async, keep-K, in the
reference's on-disk format, and the coordinated multi-process save."""
from repro_torch.checkpoint.manager import (
    CheckpointManager, ClusterCheckpointManager, latest_step, restore, save,
)

__all__ = ["CheckpointManager", "ClusterCheckpointManager", "latest_step", "restore", "save"]
