"""`FlashDevice`: memory-mapped file-backed shards (CSD ↔ NAND flash).

Models the paper's actual medium: each shard is a file of pre-tokenized
samples, and a read is an mmap page fetch, not a recompute.  The layout
mirrors the paper's custody rules:

  * **private shards** live under the owning device's own spool directory
    (``<root>/dev-<worker>/``) — its "flash".  Another device never even
    computes the path: the custody guard in
    :class:`~repro_torch.storage.device.BaseStorageDevice` rejects the read first.
  * **public shards** live in a shared pool directory (``<root>/public/``)
    written once and mapped read-only by every device — the paper's
    host-distributed public data.

Files are spooled lazily on first touch, from the same deterministic
generator the synthetic backend uses, so flash and synthetic devices return
**bit-identical** samples for the same ``(seed, shard, index)`` — the
property test in ``tests/test_storage.py`` pins this, and it is what lets a
fleet mix backends (e.g. flash CSDs + a synthetic host) without changing
training math.

Quarantine is physical here: :meth:`FlashDevice.quarantine` unlinks the
shard file (shreds the dead worker's flash) in addition to the tombstone.

Spool width is pluggable (see :mod:`repro_torch.storage.codec`): the default
``i32`` layout writes 4 bytes/token; ``u8``/``u16``/``auto`` spool narrow
integer ids (up to 4x fewer bytes at rest and through the mmap page reads)
and the device widens back to int32 during ``_materialize`` — assembled
batches are bit-identical across codecs AND backends.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np

from repro_torch.core.privacy import Shard
from repro_torch.storage.codec import decode_rows, encode_rows, resolve_codec
from repro_torch.storage.device import BaseStorageDevice
from repro_torch.storage.synthetic import synth_sequence


def _safe(name: str) -> str:
    return name.replace("/", "_").replace(os.sep, "_")


class FlashDevice(BaseStorageDevice):
    """File-backed backend: one ``(n_samples, seq_len+1)`` memmap per shard
    (dtype per the spool codec), spooled lazily, read via mmap pages."""

    backend = "flash"

    def __init__(self, worker: str, cfg, root: Optional[str] = None,
                 codec: str = "i32"):
        super().__init__(worker, cfg)
        self.root = root or tempfile.mkdtemp(prefix="repro-flash-")
        self.codec = resolve_codec(codec, cfg.vocab)
        self._maps: Dict[str, np.memmap] = {}
        self.spooled_bytes = 0          # payload bytes THIS device wrote

    # -- layout -----------------------------------------------------------

    def _shard_path(self, shard: Shard) -> str:
        if shard.private:
            home = os.path.join(self.root, f"dev-{_safe(shard.owner)}")
        else:
            home = os.path.join(self.root, "public")
        # codec in the name: devices with different codecs never alias files
        return os.path.join(home, f"{_safe(shard.shard_id)}.{self.codec}")

    def _spool(self, shard: Shard, path: str) -> None:
        """Write the shard's full sample matrix; atomic rename so a shared
        public file is never observed half-written."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        S = self.cfg.seq_len + 1
        from repro_torch.storage.codec import CODEC_DTYPES

        dt = CODEC_DTYPES[self.codec]
        tmp = path + f".tmp-{os.getpid()}-{_safe(self.worker)}"
        arr = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=dt, shape=(shard.n_samples, S)
        )
        for i in range(shard.n_samples):
            arr[i] = encode_rows(synth_sequence(self.cfg, shard.shard_id, i),
                                 self.codec)
        arr.flush()
        self.spooled_bytes += arr.nbytes
        del arr
        os.replace(tmp, path)

    def _map(self, shard: Shard) -> np.memmap:
        m = self._maps.get(shard.shard_id)
        if m is None:
            path = self._shard_path(shard)
            if not os.path.exists(path):
                self._spool(shard, path)
            m = np.load(path, mmap_mode="r")
            self._maps[shard.shard_id] = m
        return m

    # -- device hooks -----------------------------------------------------

    def _materialize(self, shard: Shard, index: int) -> np.ndarray:
        m = self._map(shard)
        # in-device widen: narrow spool bytes never leave the device raw
        return decode_rows(m[index % m.shape[0]])

    def evict(self, shard_id: str) -> None:
        self._maps.pop(shard_id, None)
        super().evict(shard_id)

    def quarantine(self, shard_id: str) -> None:
        shard = self._shards.get(shard_id)
        self._maps.pop(shard_id, None)
        if shard is not None and shard.private and shard.owner == self.worker:
            # shred the dead device's flash: the bytes cease to exist
            try:
                os.remove(self._shard_path(shard))
            except OSError:
                pass
        super().quarantine(shard_id)

    def close(self) -> None:
        self._maps.clear()
