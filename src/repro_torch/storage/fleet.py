"""`DeviceFleet`: the registry mapping dp-group workers onto storage devices.

The paper's rack is a *fleet of CSDs*: the host places work onto devices,
each device computes over its own flash, and membership changes (a CSD dies,
a replacement arrives) are custody events, not data copies.  This module is
that control plane:

  * :class:`StorageSpec` — declarative backend selection (``synthetic`` /
    ``flash``), carried by ``FleetSpec`` so one line switches the entire
    data plane.
  * :class:`DeviceFleet` — worker-id → :class:`StorageDevice` registry with
    the custody API: ``provision_worker`` (WorkerJoined), ``quarantine_workers``
    (WorkerLost: public shards re-home to survivors, private shards are
    tombstoned fleet-wide), and an auditable
    :class:`~repro_torch.core.privacy.CustodyEvent` log checked by
    :func:`~repro_torch.core.privacy.audit_custody`.
  * :class:`FleetBatcher` — the batch iterator ``Session.run()`` pulls from:
    each dp-group's rows are assembled *in its device* and stitched into the
    Stannis masked global batch; ``next_device_batch`` lands it on the
    session's torch device.
  * :class:`FleetManifest` — what ``Session.place()`` returns: the core
    privacy :class:`~repro_torch.core.privacy.PlacementManifest` plus per-device
    custody records, so placement is auditable down to the device.

A copy of ``repro/storage/fleet.py`` for one process: the ``meshfeed``
backend and the cluster's process map (remote custody records, per-process
row spans) arrive with the port's multi-device slice (ROADMAP item 13).
"""
from __future__ import annotations

import contextlib
import dataclasses
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.hetero import BatchSchedule
from repro_torch.core.privacy import CustodyEvent, PlacementManifest, Shard
from repro_torch.storage.device import BaseStorageDevice, StorageDevice
from repro_torch.storage.flash import FlashDevice
from repro_torch.storage.synthetic import DataConfig, SyntheticDevice

BACKENDS: Dict[str, Type[BaseStorageDevice]] = {
    "synthetic": SyntheticDevice,
    "flash": FlashDevice,
}


@dataclasses.dataclass(frozen=True)
class StorageSpec:
    """Declarative storage selection: which backend, and its knobs.

    ``root`` is the flash spool directory (a fresh tempdir when omitted);
    ``codec`` is the flash spool width (``i32`` legacy, ``u8``/``u16``/``auto`` narrow — see
    :mod:`repro_torch.storage.codec`; ignored by the in-memory backends).
    """

    backend: str = "synthetic"
    root: Optional[str] = None
    codec: str = "i32"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown storage backend {self.backend!r}; "
                f"choose from {sorted(BACKENDS)}"
            )
        from repro_torch.storage.codec import CODECS

        if self.codec not in CODECS:
            raise ValueError(
                f"unknown spool codec {self.codec!r}; choose from {CODECS}"
            )


@dataclasses.dataclass(frozen=True)
class DeviceRecord:
    """One device's custody summary inside a :class:`FleetManifest`."""

    worker: str
    backend: str
    custody: Tuple[str, ...]       # shard ids this device is custodian of
    n_samples: int                 # total samples under custody


@dataclasses.dataclass(frozen=True)
class FleetManifest(PlacementManifest):
    """Fleet-aware placement: core assignments + per-device custody."""

    devices: Tuple[DeviceRecord, ...] = ()
    backend: str = "synthetic"
    quarantined: Tuple[str, ...] = ()

    def device_for(self, worker: str) -> Optional[DeviceRecord]:
        for d in self.devices:
            if d.worker == worker:
                return d
        return None


class DeviceFleet:
    """Worker-id-keyed registry of storage devices (see module docstring)."""

    def __init__(self, cfg: DataConfig, spec: Optional[StorageSpec] = None):
        self.cfg = cfg
        self.spec = spec or StorageSpec()
        self._devices: Dict[str, BaseStorageDevice] = {}
        self._shards: Dict[str, Shard] = {}
        self._custody: Dict[str, str] = {}          # shard_id -> custodian
        self.quarantined: set = set()
        self.custody_log: List[CustodyEvent] = []
        self._flash_root = (
            (self.spec.root or tempfile.mkdtemp(prefix="repro-flash-"))
            if self.spec.backend == "flash" else None
        )

    # -- construction ------------------------------------------------------

    @classmethod
    def provision(
        cls,
        workers: Sequence[str],
        shards: Sequence[Shard],
        cfg: DataConfig,
        spec: Optional[StorageSpec] = None,
    ) -> "DeviceFleet":
        fleet = cls(cfg, spec)
        for s in shards:
            fleet.register_shard(s)
        for w in workers:
            fleet.provision_worker(w)
        return fleet

    def register_shard(self, shard: Shard) -> None:
        self._shards[shard.shard_id] = shard
        for dev in self._devices.values():
            dev.adopt(shard)

    def _make_device(self, worker: str) -> BaseStorageDevice:
        klass = BACKENDS[self.spec.backend]
        if klass is FlashDevice:
            return FlashDevice(worker, self.cfg, root=self._flash_root,
                               codec=self.spec.codec)
        return klass(worker, self.cfg)

    def provision_worker(self, worker: str) -> StorageDevice:
        """WorkerJoined: bring up a fresh device holding the live shard set."""
        if worker in self._devices:
            return self._devices[worker]
        dev = self._make_device(worker)
        dev.provision(list(self._shards.values()))
        for sid in self.quarantined:
            dev.quarantine(sid)       # tombstones propagate to late joiners
        self._devices[worker] = dev
        for s in self._shards.values():
            mine = s.private and s.owner == worker
            orphan_public = not s.private and (
                self._custody.get(s.shard_id) not in self._devices
            )
            if mine or orphan_public:
                self._custody[s.shard_id] = worker
                self.custody_log.append(CustodyEvent(
                    "provision", s.shard_id, s.private, dst=worker,
                ))
        return dev

    # -- custody changes (the ONE re-homing path) --------------------------

    def quarantine_workers(self, dead: Sequence[str]) -> Tuple[str, ...]:
        """WorkerLost: decommission devices; re-home public custody to
        survivors; tombstone the dead workers' private shards fleet-wide.

        Returns the quarantined (dropped) private shard ids.
        """
        dead_set = set(dead)
        dead_devices: Dict[str, BaseStorageDevice] = {}
        for w in dead_set:
            dev = self._devices.pop(w, None)
            if dev is not None:
                dead_devices[w] = dev
        survivors = [w for w in self._devices]
        dropped: List[str] = []
        for s in list(self._shards.values()):
            holder = self._custody.get(s.shard_id)
            if s.private and s.owner in dead_set:
                # privacy constraint: nobody else may ever read these bytes.
                # The owner's device quarantines FIRST — for flash that
                # shreds the file — then every survivor gets the tombstone.
                owner_dev = dead_devices.get(s.owner)
                if owner_dev is not None:
                    owner_dev.quarantine(s.shard_id)
                for dev in self._devices.values():
                    dev.quarantine(s.shard_id)
                del self._shards[s.shard_id]
                self._custody.pop(s.shard_id, None)
                self.quarantined.add(s.shard_id)
                dropped.append(s.shard_id)
                self.custody_log.append(CustodyEvent(
                    "quarantine", s.shard_id, True, src=s.owner,
                ))
            elif not s.private and holder in dead_set and survivors:
                # public custody moves: cheapest-loaded survivor takes over
                new_home = min(
                    survivors,
                    key=lambda w: sum(
                        1 for c in self._custody.values() if c == w
                    ),
                )
                self._custody[s.shard_id] = new_home
                self._devices[new_home].adopt(s)
                self.custody_log.append(CustodyEvent(
                    "rehome", s.shard_id, False, src=holder, dst=new_home,
                ))
        for dev in dead_devices.values():
            dev.close()
        return tuple(dropped)

    # -- access ------------------------------------------------------------

    @property
    def workers(self) -> Tuple[str, ...]:
        return tuple(self._devices)

    @property
    def backend(self) -> str:
        return self.spec.backend

    def device(self, worker: str) -> BaseStorageDevice:
        try:
            return self._devices[worker]
        except KeyError:
            raise KeyError(f"no storage device for worker {worker!r}") from None

    def __iter__(self) -> Iterator[BaseStorageDevice]:
        return iter(self._devices.values())

    def __len__(self) -> int:
        return len(self._devices)

    def custodian(self, shard_id: str) -> Optional[str]:
        return self._custody.get(shard_id)

    @property
    def shards(self) -> Tuple[Shard, ...]:
        return tuple(self._shards.values())

    # -- manifest / delivery ------------------------------------------------

    def manifest(self, core: PlacementManifest) -> FleetManifest:
        """Wrap the core privacy manifest with per-device custody records."""
        records = []
        for w, dev in self._devices.items():
            owned = sorted(
                sid for sid, c in self._custody.items() if c == w
            )
            records.append(DeviceRecord(
                worker=w, backend=dev.backend, custody=tuple(owned),
                n_samples=sum(self._shards[s].n_samples for s in owned),
            ))
        return FleetManifest(
            assignments=core.assignments,
            devices=tuple(records),
            backend=self.spec.backend,
            quarantined=tuple(sorted(self.quarantined)),
        )

    def to_device_batch(
        self, batch: Dict[str, np.ndarray], device: torch.device,
    ) -> Dict[str, torch.Tensor]:
        """Land host arrays on the session's device: one host-to-device copy
        per key and nothing else, held to that by
        :func:`transfer_guard_host_to_device` (the reference's meshfeed
        guards its feed the same way)."""
        crossing = sum(v.nbytes for v in batch.values()) if device.type != "cpu" else 0
        with transfer_guard_host_to_device(crossing):
            return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class _HostToDeviceCopies(TorchDispatchMode):
    """Counts the bytes of every copy from a CPU tensor to another device."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._to_copy.default:
            dst = kwargs.get("device")
            if args[0].device.type == "cpu" and dst is not None and torch.device(dst).type != "cpu":
                self.nbytes += args[0].nbytes
        elif func is torch.ops.aten.copy_.default:
            if args[1].device.type == "cpu" and args[0].device.type != "cpu":
                self.nbytes += args[1].nbytes
        return func(*args, **kwargs)


@contextlib.contextmanager
def transfer_guard_host_to_device(nbytes: int):
    """The feed boundary: the block may move exactly ``nbytes`` from host to
    device (the batch it lands) and raises if it moved any other amount, so
    no other host bytes ride along with a batch (the port's counterpart of
    the reference feed's ``jax.transfer_guard_host_to_device``)."""
    copies = _HostToDeviceCopies()
    with copies:
        yield
    if copies.nbytes != nbytes:
        raise RuntimeError(
            f"the feed moved {copies.nbytes} bytes host-to-device, not the "
            f"batch's {nbytes}")


# ---------------------------------------------------------------------------
# The Stannis batch iterator over a device fleet
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetBatcher:
    """Batch iterator over the Stannis masked layout, fed by the fleet.

    groups: list of (worker_id, batch_size, [(shard_id, n_samples), ...]).
    Yields dicts: tokens (R, S) int32, labels (R, S) int32,
    loss_mask (R, S) f32 with invalid rows zeroed, row_mask (R,) f32.
    Each dp-group's rows are assembled by ITS device (in-device batch
    assembly); the host only concatenates finished rows.
    """

    cfg: DataConfig
    schedule: BatchSchedule
    group_workers: List[str]
    group_sources: Dict[str, List[Tuple[str, int]]]   # worker -> shard draws
    fleet: DeviceFleet

    def __post_init__(self):
        self._cursor: Dict[str, int] = {w: 0 for w in self.group_workers}
        # flatten each worker's sample space: (shard_id, index) pairs
        self._space: Dict[str, List[Tuple[str, int]]] = {}
        for w in self.group_workers:
            pairs: List[Tuple[str, int]] = []
            for shard_id, n in self.group_sources.get(w, []):
                pairs.extend((shard_id, i) for i in range(n))
            self._space[w] = pairs

    def rewire(
        self,
        schedule: BatchSchedule,
        group_sources: Dict[str, List[Tuple[str, int]]],
    ) -> None:
        """Re-point the iterator at a re-planned schedule + placement while
        preserving per-worker epoch cursors (an online re-tune must not
        replay already-seen samples)."""
        cursors = dict(self._cursor)
        self.schedule = schedule
        self.group_sources = group_sources
        self.__post_init__()
        for w, c in cursors.items():
            if w in self._cursor and self._space[w]:
                self._cursor[w] = c % len(self._space[w])

    def cursors(self) -> Dict[str, int]:
        """Per-worker epoch positions (checkpoint metadata: a restore must
        resume the SAMPLING state too, or it replays already-seen data)."""
        return dict(self._cursor)

    def set_cursors(self, cursors: Dict[str, int]) -> None:
        """Fast-forward epoch positions (from checkpoint metadata)."""
        for w, c in cursors.items():
            if w in self._cursor and self._space[w]:
                self._cursor[w] = int(c) % len(self._space[w])

    def steps_per_epoch(self) -> int:
        counts = [
            len(self._space[w]) // max(1, b)
            for w, b in zip(self.group_workers, self.schedule.group_batches)
            if b > 0
        ]
        return min(counts) if counts else 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        """One global-layout host batch; each group's rows are assembled by
        its own storage device."""
        R = self.schedule.global_rows
        S = self.cfg.seq_len
        ml = self.schedule.max_local
        tokens = np.zeros((R, S + 1), np.int32)
        row_mask = self.schedule.row_mask()
        for g, (w, b) in enumerate(
            zip(self.group_workers, self.schedule.group_batches)
        ):
            space = self._space[w]
            cur = self._cursor[w]
            self._cursor[w] = (cur + b) % max(1, len(space))
            draws = [
                space[(cur + r) % max(1, len(space))] for r in range(b)
            ]
            if draws:
                tokens[g * ml:g * ml + b] = self.fleet.device(w).assemble(draws)
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "loss_mask": row_mask[:, None] * np.ones((1, S), np.float32),
            "row_mask": row_mask,
        }

    def next_device_batch(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """One step's batch, landed on ``device``."""
        b = self.next_batch()
        return self.fleet.to_device_batch(
            {k: b[k] for k in ("tokens", "labels", "loss_mask")}, device,
        )


def manifest_sources(
    manifest: PlacementManifest, group_workers: List[str]
) -> Dict[str, List[Tuple[str, int]]]:
    """Per-worker (shard_id, n_samples) draws from a placement manifest."""
    sources: Dict[str, List[Tuple[str, int]]] = {w: [] for w in group_workers}
    for a in manifest.assignments:
        if a.worker in sources:
            sources[a.worker].append((a.shard_id, a.n_samples))
    return sources


def make_fleet_batcher(
    cfg: DataConfig,
    schedule: BatchSchedule,
    group_workers: List[str],
    manifest: PlacementManifest,
    fleet: DeviceFleet,
) -> FleetBatcher:
    """Wire the Eq.1 plan + privacy manifest into a fleet-fed iterator."""
    return FleetBatcher(
        cfg=cfg, schedule=schedule, group_workers=group_workers,
        group_sources=manifest_sources(manifest, group_workers), fleet=fleet,
    )
