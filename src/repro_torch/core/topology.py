"""Worker classes and the fleet performance/energy model.

STANNIS's hardware is a heterogeneous fleet: one Xeon host + N Newport CSDs
(ARM A53 ISP engines).  We generalize that to *worker classes*: each class has a
count, a relative compute throughput, a link bandwidth to the reduction fabric,
and a power envelope.  The paper's Table I/II numbers are reproduced by
instantiating the ``paper_fleet()`` profile; TPU-fleet profiles model mixed-pod
deployments (the technique's target at our scale).

Everything here is *accounting* — pure Python over dataclasses — so the tuner,
load balancer, energy benchmark, and trainer can share one consistent model.
(A copy of ``repro/core/topology.py``; its cluster process topology --
``ProcessMap``/``TransportSpec``/``ClusterSpec`` -- drives the port's
multi-process ``hostsync`` execution, :mod:`repro_torch.launch.cluster`.)

Units: throughput in samples/s at a reference batch size, power in watts,
bandwidth in GB/s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkerClass:
    """One homogeneous group of workers (the paper has two: host, newport)."""

    name: str
    count: int
    # Peak useful training throughput for the reference net, samples/sec, at
    # saturating batch size.  The tuner *measures* this when real step
    # functions are provided; the analytic value seeds fleet-scale planning.
    peak_throughput: float
    # Batch size beyond which throughput saturates (paper: Newport ~16).
    saturation_batch: int
    # Max batch that fits DRAM (paper: Newport 8 GB shared -> small nets only).
    max_batch: int
    # Active power draw, watts (paper measures whole-rack; we model per-class).
    active_power: float
    idle_power: float = 0.0
    # Bandwidth of this worker's link into the allreduce ring, GB/s.
    link_bandwidth: float = 1.0

    def throughput_at(self, batch: int) -> float:
        """Ramp to peak by ``saturation_batch``, flat beyond (paper §V)."""
        if batch <= 0:
            return 0.0
        frac = min(1.0, batch / max(1, self.saturation_batch))
        # sub-linear ramp: small batches underutilize the engine
        return self.peak_throughput * frac ** 0.5 if frac < 1.0 else self.peak_throughput

    def step_time(self, batch: int) -> float:
        """Seconds to process one local batch."""
        tput = self.throughput_at(batch)
        return batch / tput if tput > 0 else math.inf


@dataclasses.dataclass(frozen=True)
class Fleet:
    """A heterogeneous fleet = ordered list of worker classes."""

    classes: Tuple[WorkerClass, ...]

    @property
    def n_workers(self) -> int:
        return sum(c.count for c in self.classes)

    def slowest(self) -> WorkerClass:
        return min(self.classes, key=lambda c: c.peak_throughput)

    def fastest(self) -> WorkerClass:
        return max(self.classes, key=lambda c: c.peak_throughput)

    def by_name(self, name: str) -> WorkerClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(name)

    def expand(self) -> List[WorkerClass]:
        """One entry per physical worker."""
        out: List[WorkerClass] = []
        for c in self.classes:
            out.extend([c] * c.count)
        return out

    # -- energy accounting (Table II methodology: wall power / throughput) ----
    def power(self, active: Optional[Dict[str, bool]] = None) -> float:
        total = 0.0
        for c in self.classes:
            on = True if active is None else active.get(c.name, True)
            total += c.count * (c.active_power if on else c.idle_power)
        return total

    def energy_per_sample(self, aggregate_throughput: float) -> float:
        """Joules per processed sample (paper Table II row 1)."""
        return self.power() / max(aggregate_throughput, 1e-9)


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------


def paper_fleet(n_csds: int = 24, network: str = "mobilenetv2") -> Fleet:
    """The paper's AIC server: 1 Xeon Silver 4108 host + ``n_csds`` Newport CSDs.

    Throughputs from Table I (img/s): host 31.05 / CSD 3.08 for MobileNetV2 etc.
    Power: the paper reports whole-rack energy/image (Table II); we back out a
    per-class split consistent with those rows: with 0 CSDs the rack burns
    13.10 J/img * 31.05 img/s ~= 407 W; each Newport adds ~7 W active while
    contributing 3.08 img/s (energy/image *falls* to 4.02 J at 24 CSDs).
    """
    table1 = {
        #                 host img/s, csd img/s, csd saturation batch
        "mobilenetv2": (31.05, 3.08, 16),
        "nasnet": (47.31, 2.80, 12),
        "inceptionv3": (30.80, 1.85, 12),
        "squeezenet": (219.0, 16.3, 32),
    }
    h, c, sat = table1[network]
    host = WorkerClass(
        name="host", count=1, peak_throughput=h, saturation_batch=sat * 8,
        max_batch=4096, active_power=407.0, idle_power=100.0,
        link_bandwidth=8.0,
    )
    csd = WorkerClass(
        name="newport", count=n_csds, peak_throughput=c, saturation_batch=sat,
        max_batch=64, active_power=7.0, idle_power=1.5,
        link_bandwidth=2.0,  # TCP/IP-over-PCIe tunnel
    )
    return Fleet(classes=(host, csd))


def tpu_fleet(
    n_fast_pods: int = 1,
    n_slow_pods: int = 1,
    fast_tput: float = 1.0,
    slow_tput: float = 0.55,
    chips_per_pod: int = 256,
) -> Fleet:
    """A mixed-generation TPU fleet (e.g. v5e pods + older pods).

    Throughputs are *relative* (per-pod step rate for a fixed reference batch);
    the tuner works with relative numbers identically to absolute ones.
    v5e chip ~ 170 W + host share; links are ICI (~50 GB/s after efficiency).
    """
    fast = WorkerClass(
        name="pod-fast", count=n_fast_pods, peak_throughput=fast_tput,
        saturation_batch=8, max_batch=4096,
        active_power=200.0 * chips_per_pod, idle_power=60.0 * chips_per_pod,
        link_bandwidth=50.0,
    )
    slow = WorkerClass(
        name="pod-slow", count=n_slow_pods, peak_throughput=slow_tput,
        saturation_batch=8, max_batch=4096,
        active_power=160.0 * chips_per_pod, idle_power=50.0 * chips_per_pod,
        link_bandwidth=25.0,
    )
    return Fleet(classes=(fast, slow))


# ---------------------------------------------------------------------------
# Synchronization-cost model (paper §V-A: slowdown fades beyond 5-6 nodes)
# ---------------------------------------------------------------------------


def ring_allreduce_time(
    n_params: int,
    n_workers: int,
    min_link_gbs: float,
    bytes_per_param: int = 4,
) -> float:
    """Ring allreduce wall time: 2 (n-1)/n * bytes / slowest-link-bandwidth.

    Bandwidth-optimal (Horovod/NCCL): each worker sends and receives
    ``2 (n-1)/n * B`` bytes regardless of n, through its own link; the ring is
    paced by the *slowest* link — exactly why the paper's speedup converges
    after 5-6 nodes instead of degrading.
    """
    if n_workers <= 1:
        return 0.0
    vol = 2.0 * (n_workers - 1) / n_workers * n_params * bytes_per_param
    return vol / (min_link_gbs * 1e9)


def sync_stall(n_workers: int, stall_max: float = 0.12, tau: float = 2.5) -> float:
    """Per-node slowdown from synchronization partial stalls (paper §V-A).

    The paper observes every node slows down in distributed mode and the
    slowdown CONVERGES once the ring has more than 5-6 devices (each node
    only ever talks to two neighbours).  Saturating exponential fits that:
    0 at n=1, ~95% of stall_max by n~8.
    """
    if n_workers <= 1:
        return 0.0
    return stall_max * (1.0 - math.exp(-(n_workers - 1) / tau))


def distributed_step_time(
    fleet: Fleet,
    batches: Dict[str, int],
    n_params: int,
    bytes_per_param: int = 4,
    overlap: float = 0.0,
    stall_max: float = 0.12,
) -> float:
    """Synchronous-step wall time = max compute * (1 + stall) + (1-overlap) * allreduce.

    ``overlap``: fraction of the allreduce hidden under backprop (beyond-paper
    optimization; the paper's Horovod baseline has overlap ~ 0 for small nets).
    """
    active = [c for c in fleet.classes if batches.get(c.name, 0) > 0]
    if not active:
        return math.inf
    compute = max(c.step_time(batches[c.name]) for c in active)
    n_active = sum(c.count for c in active)
    min_link = min(c.link_bandwidth for c in active)
    comm = ring_allreduce_time(n_params, n_active, min_link, bytes_per_param)
    stall = sync_stall(n_active, stall_max=stall_max)
    return compute * (1.0 + stall) + (1.0 - overlap) * comm


def fleet_throughput(
    fleet: Fleet,
    batches: Dict[str, int],
    n_params: int,
    bytes_per_param: int = 4,
    overlap: float = 0.0,
    stall_max: float = 0.12,
) -> float:
    """Aggregate samples/s for one synchronous step (paper Fig. 6 y-axis)."""
    t = distributed_step_time(
        fleet, batches, n_params, bytes_per_param, overlap, stall_max
    )
    total = sum(c.count * batches.get(c.name, 0) for c in fleet.classes)
    return total / t if t > 0 and not math.isinf(t) else 0.0


# ---------------------------------------------------------------------------
# Cluster process topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProcessMap:
    """dp-group -> worker-process assignment for multi-process execution.

    The Stannis global batch is group-major: group ``g`` owns rows
    ``[g*max_local, (g+1)*max_local)``.  A cluster of ``n_processes`` worker
    processes splits the groups into contiguous blocks (``g * P // G``), so a
    process's rows are one contiguous span of the global batch -- the slab
    its one device computes.  Each process provisions storage devices (shard
    custody) ONLY for its own groups; every other group is a remote record
    in the manifest.
    """

    group_workers: Tuple[str, ...]
    n_processes: int

    def __post_init__(self):
        if self.n_processes < 1:
            raise ValueError(f"n_processes must be >= 1, got {self.n_processes}")
        if self.n_processes > max(1, len(self.group_workers)):
            raise ValueError(
                f"{self.n_processes} processes but only "
                f"{len(self.group_workers)} dp-groups — a worker process with "
                f"no group custody has nothing to feed"
            )

    @property
    def n_groups(self) -> int:
        return len(self.group_workers)

    def process_of_group(self, g: int) -> int:
        if not 0 <= g < self.n_groups:
            raise IndexError(g)
        return g * self.n_processes // self.n_groups

    def process_of(self, worker: str) -> int:
        return self.process_of_group(self.group_workers.index(worker))

    def local_groups(self, process: int) -> range:
        g0 = math.ceil(process * self.n_groups / self.n_processes)
        g1 = math.ceil((process + 1) * self.n_groups / self.n_processes)
        return range(g0, g1)

    def local_workers(self, process: int) -> Tuple[str, ...]:
        return tuple(self.group_workers[g] for g in self.local_groups(process))

    def row_span(self, process: int, max_local: int) -> Tuple[int, int]:
        """This process's contiguous [start, stop) row window of the global
        batch (group-major layout, ``max_local`` rows per group)."""
        groups = self.local_groups(process)
        return groups.start * max_local, groups.stop * max_local


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """Gradient-reduction transport knobs for hostsync cluster execution.

    Three independently toggleable optimizations (all default off, so the
    default spec reproduces the classic full-f32 star reduction):

    * ``compression`` — ``"int8"`` per-chunk symmetric quantization (the row
      quantizer kernel, round half up) or ``"topk"`` magnitude
      sparsification (``topk_ratio`` of entries kept).  Both keep a per-host
      *error-feedback* residual so the dropped mass re-enters later steps;
      every worker decodes every peer's payload and sums in process-id
      order, so replicas stay bit-identical.
    * ``overlap`` — split the grad tree into ``buckets`` flat f32 vectors
      and pipeline bucket *i*'s gather/decode (background thread, double
      buffered) with bucket *i+1*'s encode.
    * ``topology`` — ``"ring"`` peer-to-peer allgather (workers listen on
      their own sockets; the coordinator is demoted to rendezvous +
      membership) or the ``"star"`` coordinator fallback.

    ``timeout`` bounds every blocking wire wait; a silent peer raises
    ``SyncPeerLost`` instead of hanging the step.
    """

    compression: str = "none"       # "none" | "int8" | "topk"
    topk_ratio: float = 0.01        # fraction of entries kept when "topk"
    chunk: int = 512                # int8 quantization chunk (one scale each)
    buckets: int = 1                # grad tree split into this many vectors
    overlap: bool = False           # pipeline reduce(i) with encode(i+1)
    topology: str = "star"          # "star" | "ring"
    timeout: float = 120.0          # seconds before a wire wait raises

    def __post_init__(self):
        if self.compression not in ("none", "int8", "topk"):
            raise ValueError(f"unknown compression {self.compression!r}")
        if self.topology not in ("star", "ring"):
            raise ValueError(f"unknown topology {self.topology!r}")
        if self.buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        if not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(f"topk_ratio must be in (0, 1], got {self.topk_ratio}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {self.timeout}")

    @classmethod
    def production(cls, **overrides) -> "TransportSpec":
        """The all-optimizations-on preset used by benches and smoke rigs."""
        kw = dict(compression="int8", buckets=2, overlap=True, topology="ring")
        kw.update(overrides)
        return cls(**kw)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Declarative multi-process execution: how many worker processes, and
    how they find each other.  Carried by ``FleetSpec.with_cluster`` so one
    line turns a single-process session into a cluster launch.

    ``local_devices`` is the per-process device count: 0 or 1 (one torch
    device a process; more is the rest of the second half of ROADMAP item 19).
    ``sync_port`` is the coordinator's sync service (0 picks a free one at
    launch); it is also the ring's rendezvous.  ``membership_dir`` is where
    worker heartbeats land for the
    :class:`~repro_torch.api.membership.MembershipWatcher` (a fresh tempdir
    when omitted).  ``transport`` selects the hostsync gradient reduction
    path (see :class:`TransportSpec`).  ``mode`` is the execution mode,
    ``"spmd"`` or ``"hostsync"``; ``None`` lets each worker's
    ``ClusterContext.detect`` pick it.  The ``spmd`` process group meets
    at a file store in the coordinator's run directory (the reference's
    ``coordinator_port`` is the ``jax.distributed`` rendezvous); the
    reference's ``compile_cache_dir`` (a shared XLA compilation cache) has
    nothing to point at in eager PyTorch.
    """

    processes: int = 1
    local_devices: int = 0
    sync_port: int = 0
    membership_dir: Optional[str] = None
    heartbeat_interval: float = 0.25
    transport: TransportSpec = dataclasses.field(default_factory=TransportSpec)
    mode: Optional[str] = None

    def __post_init__(self):
        if self.processes < 1:
            raise ValueError(
                f"cluster needs >= 1 process, got {self.processes}"
            )
        if self.local_devices > 1:
            raise NotImplementedError(
                f"local_devices={self.local_devices}: a worker process drives one "
                f"torch device; several devices a process is the rest of the second "
                f"half of ROADMAP item 19 'Multi-device'"
            )
        if self.mode not in (None, "spmd", "hostsync"):
            raise ValueError(f"unknown cluster mode {self.mode!r}")
        if isinstance(self.transport, dict):
            object.__setattr__(self, "transport", TransportSpec(**self.transport))
