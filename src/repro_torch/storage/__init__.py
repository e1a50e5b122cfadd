"""`repro_torch.storage` — computational storage as a first-class subsystem
(copy of :mod:`repro.storage` for one process).

STANNIS's central claim is that training happens *inside* the storage
devices: private data never crosses the device boundary, public data is
shared deliberately, and the host *places work onto* devices rather than
reading bytes out of them.  This package is that device model:

    CSD (paper)            repro_torch.storage (here)
    -------------------    ------------------------------------------
    NAND flash + shards    StorageDevice custody table (Shard set)
    ISP engine             in-device read()/assemble() sampling
    NVMe boundary          PermissionError custody guard
    rack of CSDs           DeviceFleet (worker id -> device registry)
    device failure         quarantine_workers: public re-homes,
                           private tombstones (CustodyEvent log)
    host DMA / fabric      FleetBatcher.next_device_batch delivery

Two interchangeable backends (select via ``StorageSpec`` /
``FleetSpec.with_storage``):

  * ``synthetic`` — deterministic in-silico corpus, zero setup (default).
  * ``flash``     — memory-mapped file-backed shards, bit-identical to
    synthetic; models the paper's flash medium.

The reference's third backend, ``meshfeed`` (batches born sharded over a
device mesh), comes with the port's multi-device slice (ROADMAP item 13).
"""
from repro_torch.storage.device import BaseStorageDevice, StorageDevice
from repro_torch.storage.flash import FlashDevice
from repro_torch.storage.fleet import (
    BACKENDS, DeviceFleet, DeviceRecord, FleetBatcher, FleetManifest,
    StorageSpec, make_fleet_batcher, manifest_sources,
)
from repro_torch.storage.synthetic import DataConfig, SyntheticDevice, synth_sequence

__all__ = [
    "BACKENDS",
    "BaseStorageDevice",
    "DataConfig",
    "DeviceFleet",
    "DeviceRecord",
    "FlashDevice",
    "FleetBatcher",
    "FleetManifest",
    "StorageDevice",
    "StorageSpec",
    "SyntheticDevice",
    "make_fleet_batcher",
    "manifest_sources",
    "synth_sequence",
]
