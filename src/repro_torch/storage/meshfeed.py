"""`MeshFeedDevice`: per-dp-group feeding of a process's own rows onto its
device (port of :mod:`repro.storage.meshfeed`, one device a process).

The reference stitches the global batch from per-device shards of a
``jax.sharding.Mesh``; in a multi-process cluster each process
``device_put``s only its **addressable** slice.  The port runs one torch
device a process, so a process's addressable slice is exactly its row span
of the global batch: :meth:`MeshFeeder.feed_addressable` picks only the
rows THIS process holds (given their offset into the global batch) and
slices out the adopted span of them.  The copy to the device is
:meth:`~repro_torch.storage.fleet.DeviceFleet.to_device_batch`'s, the one
guarded host-to-device copy of the port, for this backend and the others
alike.  The per-feed :class:`FeedReceipt` records which device receives how
many bytes.  A span outside the rows this process holds raises (feed plan
and shard custody disagree), as the reference's does.

``StorageSpec(data_axis=...)`` pins the feed's data axis.  Above 1 it is
accepted where it equals the cluster's world (its processes, one device
each: the ``spmd`` mesh's data axis, replicated or ZeRO-3), and each rank
lands only its own span.  Any other value would put several devices in a
process, the rest of the second half of ROADMAP item 19, and raises
``NotImplementedError``.

Sampling custody is inherited from :class:`SyntheticDevice` -- mesh feeding
changes where batches *land*, never who may *read* a shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import SHARDED_WEIGHTS
from repro_torch.storage.synthetic import SyntheticDevice


class MeshFeedDevice(SyntheticDevice):
    """Synthetic sampling + span-placed batch delivery (see module doc)."""

    backend = "meshfeed"


def data_axis_size(global_rows: int, n_devices: int) -> int:
    """Largest divisor of ``global_rows`` that fits the device count."""
    if global_rows <= 0:
        return 1
    for d in range(min(n_devices, global_rows), 0, -1):
        if global_rows % d == 0:
            return d
    return 1


@dataclasses.dataclass(frozen=True)
class FeedReceipt:
    """Byte-exact accounting of ONE per-process feed.

    ``bytes_put`` is every host->device byte this feed moves (the transfer
    guard around ``DeviceFleet.to_device_batch``'s copy holds it to that);
    ``devices`` are the destination device indices, all this process's own.
    """

    rows_local: int                  # host rows this process supplied
    rows_global: int                 # rows of the global batch
    bytes_put: int                   # h2d bytes moved (all keys)
    n_puts: int                      # tensor copies to issue
    devices: Tuple[int, ...]         # destination device indices
    process_index: int               # which process fed

    @property
    def local_fraction(self) -> float:
        return self.rows_local / max(1, self.rows_global)


class MeshFeeder:
    """Picks the rows a process lands on its one device, per the adopted plan.

    :meth:`adopt` records the session's device, the global row count the
    plan was resolved for and this process's [start, stop) span of it.  A
    feed of a different row count (mid-replan, before the session adopts
    the re-derived plan) ignores the stale span and lands every row it was
    given.
    """

    def __init__(self, data_axis: Optional[int] = None, *, process_index: int = 0,
                 world: int = 1):
        if data_axis is not None and data_axis > 1 and data_axis != world:
            raise NotImplementedError(
                f"a meshfeed data axis of {data_axis} devices over {world} process(es): "
                f"the port feeds one device a process, so the data axis is the world; "
                f"several devices a process is {SHARDED_WEIGHTS}")
        self.process_index = int(process_index)
        self._device: Optional[torch.device] = None
        self._plan_rows: Optional[int] = None
        self._span: Optional[Tuple[int, int]] = None
        self.last_receipt: Optional[FeedReceipt] = None

    @property
    def device(self) -> torch.device:
        """The adopted plan's device, where the fed rows land."""
        if self._device is None:
            raise RuntimeError("MeshFeeder: no plan adopted (Session.shard() adopts one)")
        return self._device

    def adopt(self, device: torch.device, global_rows: int,
              span: Optional[Tuple[int, int]] = None) -> None:
        """Adopt a plan: ``device`` receives rows ``span`` (default: all
        ``global_rows``) of every global batch of ``global_rows`` rows."""
        self._device = torch.device(device)
        self._plan_rows = int(global_rows)
        self._span = tuple(span) if span is not None else (0, int(global_rows))

    def feed(self, batch: Dict[str, np.ndarray], *,
             row_span: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
        """The rows to land, from a global-layout host batch: with
        ``row_span`` (this process's [start, stop) window, cluster mode) only
        those rows are sliced out and fed through :meth:`feed_addressable` —
        the rest of ``batch`` is never transferred; without it, the full row
        window."""
        if row_span is None:
            return self.feed_addressable(batch)
        start, stop = row_span
        rows = next(iter(batch.values())).shape[0]
        local = {k: v[start:stop] for k, v in batch.items()}
        return self.feed_addressable(local, row_offset=start, global_rows=rows)

    def feed_addressable(
        self,
        batch: Dict[str, np.ndarray],
        *,
        row_offset: int = 0,
        global_rows: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """THIS process's span of rows, contiguous on the host, for
        :attr:`device`; records the feed's :class:`FeedReceipt`.

        ``batch`` holds only the local rows; ``row_offset``/``global_rows``
        situate them in the global batch (defaults: the batch IS the global
        batch).  Raises if the adopted span reaches beyond the rows this
        process holds (custody/plan misalignment)."""
        device = self.device
        local_rows = next(iter(batch.values())).shape[0]
        R = global_rows if global_rows is not None else local_rows
        start, stop = self._span if self._plan_rows == R else (row_offset,
                                                               row_offset + local_rows)
        if start < row_offset or stop > row_offset + local_rows:
            raise ValueError(
                f"the addressable rows [{start}:{stop}) fall outside this host's "
                f"rows [{row_offset}:{row_offset + local_rows}) — feed plan and "
                f"shard custody disagree")
        pieces = {k: np.ascontiguousarray(v[start - row_offset:stop - row_offset])
                  for k, v in batch.items()}
        self.last_receipt = FeedReceipt(
            rows_local=int(local_rows),
            rows_global=int(R),
            bytes_put=int(sum(p.nbytes for p in pieces.values())),
            n_puts=len(pieces),
            devices=(device.index or 0,),
            process_index=self.process_index,
        )
        return pieces
