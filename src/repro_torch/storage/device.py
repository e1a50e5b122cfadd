"""`StorageDevice`: the computational-storage abstraction (paper C1/C3).

STANNIS trains *inside* the storage devices: each Newport CSD holds shards
of the corpus on its flash, its ISP engine is the only compute that may
touch them, and private shards never cross the NVMe boundary.  A
``StorageDevice`` is this repo's software model of one such device:

  * **custody** — the device holds a table of shards it may serve: its own
    private shards plus the public pool.  A read of a private shard it does
    not own raises ``PermissionError`` (the host-side analogue of "the bytes
    physically cannot leave the flash").
  * **in-device sampling** — ``read(shard_id, index)`` materializes one
    sample *on the device*; ``assemble(draws)`` builds a whole per-dp-group
    batch without any sample crossing a device boundary.
  * **quarantine** — when a device's worker dies, its private shards are
    tombstoned fleet-wide (:meth:`quarantine`): even stale readers get a
    ``PermissionError``, never bytes.

Backends subclass :class:`BaseStorageDevice` and implement a single hook,
``_materialize(shard, index)``.  The custody guard runs *before* the hook,
so no backend can leak a private sample by construction.  See
:mod:`repro_torch.storage.synthetic` and :mod:`repro_torch.storage.flash` for
the two ported backends (``meshfeed`` arrives with the multi-device slice), and
:mod:`repro_torch.storage.fleet` for the registry that maps CSDs onto dp-group
workers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core.privacy import Shard


class StorageDevice(Protocol):
    """What the fleet and batcher require of a storage backend."""

    worker: str
    backend: str

    def provision(self, shards: Sequence[Shard]) -> None: ...
    def read(self, shard_id: str, index: int) -> np.ndarray: ...
    def assemble(self, draws: Sequence[Tuple[str, int]]) -> np.ndarray: ...
    def holdings(self) -> Tuple[Shard, ...]: ...
    def adopt(self, shard: Shard) -> None: ...
    def evict(self, shard_id: str) -> None: ...
    def quarantine(self, shard_id: str) -> None: ...


class BaseStorageDevice:
    """Custody bookkeeping shared by every backend.

    Subclasses set ``backend`` and implement ``_materialize(shard, index) ->
    (seq_len+1,) int32`` — called only after the custody guard passed.
    """

    backend = "abstract"

    def __init__(self, worker: str, cfg):
        self.worker = worker
        self.cfg = cfg                      # DataConfig: sample geometry
        self._shards: Dict[str, Shard] = {}
        self._quarantined: set = set()

    # -- custody ----------------------------------------------------------

    def provision(self, shards: Sequence[Shard]) -> None:
        """Install the device's shard table (its privates + the public pool)."""
        for s in shards:
            self.adopt(s)

    def adopt(self, shard: Shard) -> None:
        self._shards[shard.shard_id] = shard
        self._quarantined.discard(shard.shard_id)

    def evict(self, shard_id: str) -> None:
        self._shards.pop(shard_id, None)

    def quarantine(self, shard_id: str) -> None:
        """Tombstone: the shard's owner died; reads must fail loudly forever
        (a silent KeyError would let a caller mistake 'gone' for 'unknown')."""
        self._shards.pop(shard_id, None)
        self._quarantined.add(shard_id)

    def holdings(self) -> Tuple[Shard, ...]:
        return tuple(self._shards.values())

    def _guard(self, shard_id: str) -> Shard:
        if shard_id in self._quarantined:
            raise PermissionError(
                f"shard {shard_id!r} is quarantined (its owner left the "
                f"fleet); private data dies with its device"
            )
        try:
            s = self._shards[shard_id]
        except KeyError:
            raise KeyError(
                f"device {self.worker!r} holds no shard {shard_id!r}"
            ) from None
        if s.private and s.owner != self.worker:
            raise PermissionError(
                f"device {self.worker!r} cannot read private shard "
                f"{shard_id!r} (owner {s.owner!r})"
            )
        return s

    # -- in-device sampling ----------------------------------------------

    def read(self, shard_id: str, index: int) -> np.ndarray:
        """One custody-checked sample: (seq_len+1,) int32 token ids."""
        return self._materialize(self._guard(shard_id), index)

    def assemble(self, draws: Sequence[Tuple[str, int]]) -> np.ndarray:
        """In-device batch assembly: (len(draws), seq_len+1) int32.

        The whole dp-group batch is built on the device; only the finished
        rows leave it (the paper's ISP engine streaming activations, not
        raw flash pages).
        """
        S = self.cfg.seq_len + 1
        out = np.zeros((len(draws), S), np.int32)
        for r, (shard_id, idx) in enumerate(draws):
            out[r] = self.read(shard_id, idx)
        return out

    def _materialize(self, shard: Shard, index: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        """Release backend resources (files, maps); default no-op."""

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} worker={self.worker!r} "
                f"shards={len(self._shards)}>")
