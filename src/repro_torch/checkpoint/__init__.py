"""Checkpointing of the port: atomic, CRC-checked, async, keep-K, in the
reference's on-disk format, and the coordinated multi-process save (per-shard
chunks under ZeRO-3)."""
from repro_torch.checkpoint.manager import (
    CheckpointManager, ClusterCheckpointManager, finalize_process_save, latest_step, restore,
    save, save_process,
)

__all__ = ["CheckpointManager", "ClusterCheckpointManager", "finalize_process_save",
           "latest_step", "restore", "save", "save_process"]
