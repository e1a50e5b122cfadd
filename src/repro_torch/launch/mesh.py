"""Meshes over a cluster's ranks and a worker process's identity inside a
cluster (port of :mod:`repro.launch.mesh`).

The port drives one torch device a process.  A mesh of several devices is
a ``torch.distributed`` ``DeviceMesh`` over the ranks of the default
process group, one device a rank, its dims named ``("data", "model")``:
:func:`make_host_mesh` (any ``data x model``: the tensor- and
expert-parallel step's, ``train.steps.make_spmd_train_step(plan=)``) and
:func:`make_cluster_mesh` (``model = 1``, as the reference's cluster).  Without a process
group, a plan resolves against a
:class:`~repro_torch.distributed.sharding.ProcessMesh` (its shape only):
:func:`make_single_mesh` for one process, :meth:`ClusterContext.global_mesh`
for a ``hostsync`` cluster.  A rank mesh's device type is its ranks'
devices' (a context's device), never read back from the backend: ranks
that share a card run ``gloo`` over card tensors.  The reference's
production meshes (``make_production_mesh``, 512 devices) and several
devices a process are the rest of the second half of ROADMAP item 19.

The card's peaks, which the roofline (:mod:`repro_torch.roofline`) and
``chip_smoke.py``'s kernel bounds read, are the counterparts of the
reference's TPU constants: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
power limit.  They live in :mod:`repro_torch.device`, below the kernels
whose meta routes count against them, and are re-exported here.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.device import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS,  # noqa: F401
                                PEAK_FLOPS_BF16, PEAK_FLOPS_F32)
from repro_torch.distributed.sharding import (SHARDED_WEIGHTS, ProcessMesh, check_plan,
                                              is_zero3, mesh_axis_sizes)

AXES = ("data", "model")


class RankDevice(NamedTuple):
    """One device of the global view: the process (rank) that drives it and
    its id in the view (the port: one device a rank, ``id == rank``)."""

    process_index: int
    id: int


def cluster_devices(world: int) -> List[RankDevice]:
    """The global device view of a ``world``-rank group, one device a rank."""
    return [RankDevice(r, r) for r in range(world)]


def _rank_mesh(ranks: Sequence[int], data: int, model: int, device_type: str,
               axis_names: Tuple[str, ...] = AXES):
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def make_host_mesh(*, data: int = 1, model: int = 1,
                   axis_names: Tuple[str, ...] = AXES):
    """A ``data x model`` ``DeviceMesh`` over the first ``data * model``
    ranks of the default process group (smoke tests), on ``cuda`` under
    NCCL, else on ``cpu``."""
    import torch.distributed as dist

    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got data={data}, model={model}")
    n = dist.get_world_size()
    if data * model > n:
        raise ValueError(
            f"host mesh ({data} x {model}) needs {data * model} ranks but the process group "
            f"has {n}; launch more ranks or shrink the mesh")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _rank_mesh(range(data * model), data, model, device_type, axis_names)


def make_single_mesh(axis_names: Tuple[str, ...] = AXES,
                     device: Optional[torch.device] = None) -> ProcessMesh:
    """Degenerate 1 x 1 mesh over one device (no process group needed):
    what a single-process ``Session.shard()`` resolves the rule table
    against."""
    return ProcessMesh(device=torch.device(device or "cpu"), shape=(1,) * len(axis_names),
                       mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# Cluster (multi-process) meshes
# ---------------------------------------------------------------------------


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


def pick_cluster_devices(devices: Sequence[RankDevice], data: int, model: int,
                         n_processes: int) -> List[RankDevice]:
    """An EQUAL share of ``data * model`` devices from every process, in id
    order, so chunk ownership and row custody coincide.  The port drives
    one device a process, so the share must be one."""
    need = data * model
    if need % n_processes:
        raise ValueError(f"cluster mesh ({data} x {model}) does not split over "
                         f"{n_processes} processes")
    share = need // n_processes
    if share > 1:
        raise NotImplementedError(
            f"cluster mesh ({data} x {model}) over {n_processes} processes puts {share} "
            f"devices in each; a process drives one device: several devices a process is "
            f"{SHARDED_WEIGHTS}")
    by_proc: Dict[int, List[RankDevice]] = {}
    for d in sorted(devices, key=lambda d: (d.process_index, d.id)):
        by_proc.setdefault(d.process_index, []).append(d)
    if len(by_proc) != n_processes:
        raise ValueError(f"global device view spans {len(by_proc)} processes, "
                         f"expected {n_processes}")
    return [by_proc[p][0] for p in sorted(by_proc)]


def make_cluster_mesh(*, data: int, model: int = 1, n_processes: int = 1,
                      device_type: str, axis_names: Tuple[str, ...] = AXES):
    """The GLOBAL ``DeviceMesh`` of an ``spmd`` cluster: every rank's
    device (of ``device_type``), process-major
    (:func:`pick_cluster_devices`), so process ``p``'s device holds exactly
    the row slab ``[p*R/P, (p+1)*R/P)``.  Built the same way on every rank
    (a collective: every rank must call it)."""
    import torch.distributed as dist

    devs = pick_cluster_devices(cluster_devices(dist.get_world_size()), data, model,
                                n_processes)
    return _rank_mesh([d.process_index for d in devs], data, model, device_type, axis_names)


@dataclasses.dataclass
class ClusterContext:
    """This process's identity inside a multi-process cluster.

    Built by :class:`repro_torch.launch.cluster.WorkerRuntime` and attached
    to a ``Session`` (:meth:`~repro_torch.api.session.Session.attach_cluster`).
    ``mode`` selects the execution strategy:

      * ``"spmd"``     -- one rank a process of a ``torch.distributed``
        group: each rank computes the partial gradient over its rows,
        ``all_reduce`` sums gradients and the masked loss's numerator and
        denominator, and every rank applies the identical update
        (:func:`~repro_torch.train.steps.make_spmd_train_step`); under a
        plan that shards weights over ``data``, ZeRO-3 (each rank holds
        and updates its shards, gathering a layer's weights where it runs).
      * ``"hostsync"`` -- no process group: the processes sum their partial
        gradients through the socket transport (the paper's host
        aggregation); several processes may share one card.

    Both are numerically the single-program step for dense models (the
    masked loss is a ratio of across-process sums).  :meth:`detect` picks
    the mode.  ``sync`` is the coordinator control-plane client (duck-typed:
    ``allreduce(tag, tree) -> tree`` and ``barrier(tag)``); ``None`` for a
    single-process run.  ``transport`` is the hostsync gradient wire
    (:func:`repro_torch.launch.transport.build_wire_transport` — star or
    ring) configured by ``transport_spec``; the hostsync compile wraps it
    in a :class:`~repro_torch.launch.transport.GradReducer` cached here as
    ``grad_reducer`` so error-feedback residuals survive recompiles.
    ``device`` is the torch device this process trains on.  ``backend``
    is the ``spmd`` group's (default: ``nccl`` for a CUDA device, ``gloo``
    otherwise); ranks that share a card name ``gloo``, since NCCL puts no
    two ranks on one card.
    """

    process_id: int
    n_processes: int
    mode: str = "hostsync"                 # "spmd" | "hostsync"
    sync: Any = None
    member: Optional[str] = None           # membership id (heartbeat name)
    transport: Any = None                  # wire layer (star/ring), or None
    transport_spec: Any = None             # TransportSpec, or None
    grad_reducer: Any = None               # GradReducer cache (set at compile)
    device: Optional[torch.device] = None
    backend: Optional[str] = None           # spmd group: "nccl" | "gloo"; None: by device
    _meshes: Dict[Tuple[int, int], Any] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.mode not in ("spmd", "hostsync"):
            raise ValueError(f"unknown cluster mode {self.mode!r}")
        dev = torch.device(self.device if self.device is not None else "cpu")
        if self.backend is None:
            self.backend = "nccl" if dev.type == "cuda" else "gloo"
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown process group backend {self.backend!r}")
        if self.backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"NCCL needs a CUDA device, not {dev}")

    @classmethod
    def detect(cls, process_id: int, n_processes: int, *, device=None,
               n_cards: Optional[int] = None, plan=None, **kw) -> "ClusterContext":
        """``spmd`` where it can run: a CUDA worker bound to its own card
        ``cuda:{process_id}`` (NCCL refuses two ranks on one card), no more
        workers than the ``n_cards`` cards (default:
        ``torch.cuda.device_count()``), and a ``plan`` -- the one
        ``n_processes`` ranks resolve
        (:meth:`~repro_torch.api.session.Session.spmd_plan`) -- that
        :func:`~repro_torch.distributed.sharding.check_plan` passes, on a
        ``model`` axis of one (the cluster's mesh keeps ``model = 1``, as
        the reference's): leaves whole or sharded over ``data`` (ZeRO-3).
        Otherwise ``hostsync``: CPU workers, workers sharing a card, or a
        plan resolved over ``model``, refused, or not given.  Prints the
        mode it chose and why."""
        dev = torch.device(device if device is not None else "cpu")
        mode = "hostsync"
        if dev.type != "cuda":
            why = f"{dev.type} workers"
        else:
            if n_cards is None:
                n_cards = torch.cuda.device_count()
            if n_processes > n_cards:
                why = f"{n_processes} workers on {n_cards} card(s)"
            elif dev.index != process_id:
                why = f"worker {process_id} is on {dev}, not a card of its own"
            elif plan is None:
                why = "no plan to check"
            elif mesh_axis_sizes(plan.mesh).get("model", 1) > 1:
                why = (f"the plan is resolved on a model axis of "
                       f"{mesh_axis_sizes(plan.mesh)['model']}; the cluster's mesh keeps "
                       f"model = 1, as the reference's (tensor parallelism runs on "
                       f"make_host_mesh)")
            else:
                try:
                    check_plan(plan, n_processes)
                    mode, why = "spmd", f"{n_processes} worker(s), a card each"
                    if is_zero3(plan):
                        why += ", weights ZeRO-3 sharded over data"
                except NotImplementedError as exc:
                    why = f"the plan is not ported: {exc}"
        print(f"[cluster] process {process_id}/{n_processes}: mode {mode} ({why})", flush=True)
        return cls(process_id=process_id, n_processes=n_processes, mode=mode, device=dev, **kw)

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0

    # -- the spmd process group ----------------------------------------------

    def init_process_group(self, init_method: Optional[str], timeout: float) -> bool:
        """Join the ``spmd`` process group over :attr:`backend`, rendezvous
        at ``init_method`` (``file://...`` or ``tcp://host:port``),
        ``timeout`` seconds on the rendezvous and every collective.  A
        backend that cannot start raises; nothing falls back to another.  A
        group that is already up (the caller's) is checked and kept.  ->
        whether this call created the group."""
        import torch.distributed as dist

        if self.mode != "spmd":
            raise ValueError(f"a {self.mode!r} cluster has no process group")
        dev = torch.device(self.device if self.device is not None else "cpu")
        backend = self.backend
        if dist.is_initialized():
            got = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
            if got != (backend, self.process_id, self.n_processes):
                raise RuntimeError(f"the process group is up as (backend, rank, world) "
                                   f"{got}; this worker is "
                                   f"{(backend, self.process_id, self.n_processes)}")
            return False
        if init_method is None:
            raise ValueError("an spmd worker needs a rendezvous (file://... or tcp://host:port)")
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group(backend, init_method=init_method, world_size=self.n_processes,
                                rank=self.process_id,
                                timeout=datetime.timedelta(seconds=timeout), **kw)
        return True

    # -- meshes ------------------------------------------------------------

    def global_mesh(self, global_rows: int):
        """The mesh the cluster's plan resolves against: ``spmd``, the
        ``DeviceMesh`` over every rank (cached a shape: building one is a
        collective); ``hostsync``, the processes' grid as a
        :class:`ProcessMesh`."""
        d = cluster_data_axis(global_rows, self.n_processes, self.n_processes)
        if self.mode == "hostsync":
            return ProcessMesh(device=torch.device(self.device or "cpu"), shape=(d, 1))
        if (d, 1) not in self._meshes:
            self._meshes[(d, 1)] = make_cluster_mesh(
                data=d, model=1, n_processes=self.n_processes,
                device_type=torch.device(self.device or "cpu").type)
        return self._meshes[(d, 1)]

    def local_mesh(self, local_rows: int, data_axis: Optional[int] = None) -> ProcessMesh:
        """Mesh over THIS process's device (the hostsync compute mesh): one
        device, so ``data_axis`` must be 1."""
        d = 1 if data_axis is None else data_axis
        if d != 1 or local_rows < 0:
            raise NotImplementedError(
                f"local mesh data axis {d} for {local_rows} rows: a process drives one "
                f"device; several devices a process is {SHARDED_WEIGHTS}")
        return ProcessMesh(device=torch.device(self.device or "cpu"))
