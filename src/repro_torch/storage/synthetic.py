"""`SyntheticDevice`: the deterministic in-silico corpus (CSD ↔ PRNG).

Plays the role of the paper's TinyImageNet-on-flash without any bytes on
disk: sample ``i`` of shard ``s`` is a pure function of ``(seed, s, i)``, so
any device reproduces ITS shards bit-exactly with zero cross-device I/O —
the in-storage property, minus the flash.  Sequences are Zipf-distributed
token ids with a linear-congruential position mix so the LM loss actually
decreases during the end-to-end example runs.

This module owns the canonical :class:`DataConfig` and
:func:`synth_sequence`.  :class:`~repro_torch.storage.flash.FlashDevice` spools
exactly these samples onto memory-mapped files, which is what makes the two
backends bit-identical (property-tested in ``tests/test_storage.py``).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.privacy import Shard
from repro_torch.storage.device import BaseStorageDevice


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2      # token unigram skew


def _mix(*vals: int) -> np.random.Generator:
    return np.random.default_rng(np.array(vals, np.uint64))


def synth_sequence(cfg: DataConfig, shard_id: str, index: int) -> np.ndarray:
    """Deterministic (seed, shard, index) -> (seq_len+1,) int32 token ids.

    Zipf unigram + LCG positional drift gives learnable low-entropy structure.
    """
    # crc32 (not hash()): stable across processes — workers must agree bit-exactly
    h = zlib.crc32(shard_id.encode()) & 0x7FFFFFFF
    rng = _mix(cfg.seed, h, index)
    z = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1).astype(np.int64)
    base = z % max(2, cfg.vocab // 4)
    drift = (np.arange(cfg.seq_len + 1, dtype=np.int64) * (h % 97 + 1)) % 13
    return ((base + drift) % cfg.vocab).astype(np.int32)


class SyntheticDevice(BaseStorageDevice):
    """Deterministic generator backend — the default, zero-setup device."""

    backend = "synthetic"

    def _materialize(self, shard: Shard, index: int) -> np.ndarray:
        return synth_sequence(self.cfg, shard.shard_id, index)
