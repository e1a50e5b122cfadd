"""A worker process's identity inside a multi-process cluster (port of the
cluster half of :mod:`repro.launch.mesh`).

The reference builds device meshes here; the port drives one torch device a
process, so what it keeps is :class:`ClusterContext` and the data-axis rule
:func:`cluster_data_axis`.  Meshes of several devices (``make_host_mesh``,
``make_cluster_mesh``, the ``spmd`` mode) are the multi-device half of the
port, ROADMAP item 19.

The card's peaks, which the roofline (:mod:`repro_torch.roofline`) and
``chip_smoke.py``'s kernel bounds read, are the counterparts of the
reference's TPU constants: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
power limit.  They live in :mod:`repro_torch.device`, below the kernels
whose meta routes count against them, and are re-exported here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.device import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS,  # noqa: F401
                                PEAK_FLOPS_BF16, PEAK_FLOPS_F32)
from repro_torch.storage.meshfeed import ROADMAP_MULTI_DEVICE



def cluster_data_axis(global_rows: int, n_devices: int, n_processes: int) -> int:
    """Largest ``data`` axis that divides ``global_rows``, fits ``n_devices``,
    and is a multiple of ``n_processes`` — so the row chunks never straddle a
    process boundary (each process's rows land only on its own devices).
    Falls back to ``n_processes`` itself (one chunk per process)."""
    if global_rows <= 0:
        return n_processes
    for d in range(min(n_devices, global_rows), n_processes - 1, -1):
        if d % n_processes == 0 and global_rows % d == 0:
            return d
    return n_processes


@dataclasses.dataclass
class ClusterContext:
    """This process's identity inside a multi-process cluster.

    Built by :class:`repro_torch.launch.cluster.WorkerRuntime` and attached
    to a ``Session`` (:meth:`~repro_torch.api.session.Session.attach_cluster`).
    ``mode`` is ``"hostsync"``: each process computes the partial gradient
    over its own row slab on its one device and the processes sum them
    through the transport (the paper's host-aggregation topology),
    numerically the single-program step for dense models.  ``"spmd"`` (one
    program across processes' devices) is ROADMAP item 19 and raises.

    ``sync`` is the coordinator control-plane client (duck-typed:
    ``allreduce(tag, tree) -> tree`` and ``barrier(tag)``); ``None`` for a
    single-process run.  ``transport`` is the gradient wire
    (:func:`repro_torch.launch.transport.build_wire_transport` — star or
    ring) configured by ``transport_spec``; the session's hostsync compile
    wraps it in a :class:`~repro_torch.launch.transport.GradReducer` cached
    here as ``grad_reducer`` so error-feedback residuals survive recompiles.
    ``device`` is the torch device this process trains on.
    """

    process_id: int
    n_processes: int
    mode: str = "hostsync"
    sync: Any = None
    member: Optional[str] = None           # membership id (heartbeat name)
    transport: Any = None                  # wire layer (star/ring), or None
    transport_spec: Any = None             # TransportSpec, or None
    grad_reducer: Any = None               # GradReducer cache (set at compile)
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.mode == "spmd":
            raise NotImplementedError(
                f"cluster mode 'spmd' runs one program across processes' devices: "
                f"{ROADMAP_MULTI_DEVICE}; the port runs 'hostsync'")
        if self.mode != "hostsync":
            raise ValueError(f"unknown cluster mode {self.mode!r}")
