"""Worker classes and the fleet performance/energy model.

STANNIS's hardware is a heterogeneous fleet: one Xeon host + N Newport CSDs
(ARM A53 ISP engines).  We generalize that to *worker classes*: each class has a
count, a relative compute throughput, a link bandwidth to the reduction fabric,
and a power envelope.  The paper's Table I/II numbers are reproduced by
instantiating the ``paper_fleet()`` profile; TPU-fleet profiles model mixed-pod
deployments (the technique's target at our scale).

Everything here is *accounting* — pure Python over dataclasses — so the tuner,
load balancer, energy benchmark, and trainer can share one consistent model.
(A copy of ``repro/core/topology.py`` without its cluster process topology
— ``ProcessMap``/``TransportSpec``/``ClusterSpec`` — which arrives with the
port's multi-process slice.)

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
