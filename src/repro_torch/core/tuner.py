"""Stannis tuning algorithm (paper Algorithm 1), faithful control flow.

The paper's pseudo-code:

    Function Tune(IP_newport, IP_host, C):
        for batch sizes in list of BS:
            run benchmark on Newport
            update BS_newport to the best one; update time_newport
        let E = margin scale
        while (time_host - time_newport) < (time_newport / E):
            BS_host += BS_host * (time_newport - time_host) / C
            run benchmark on host; get time_host
        return (BS_newport, BS_host)

Interpretation used here (validated against Table I):
  1. Sweep candidate batch sizes on the *slowest* class, pick the one with the
     best samples/sec that fits DRAM -> (BS_slow, time_slow).
  2. Grow every faster class's batch size by ``BS * Δtime / (time · C)``
     increments; the loop exits when ``time_fast - time_slow >= time_slow/E``,
     i.e. the fast class is deliberately loaded ~``1/E`` *beyond* equality.
     The margin absorbs the synchronization slowdown the fast engine suffers
     in distributed mode (it also runs the tunnel/aggregation processes).
     The paper fixes a 20% margin (E = 5); Table I confirms:
     MobileNetV2 host 315/31.05 = 10.14s vs Newport 25/3.08 = 8.12s (+25%),
     NASNet 6.87s vs 5.36s (+28%), our model reproduces 302/16 etc.
  3. C controls the update granularity: larger C = finer steps.

The benchmark callback abstracts "run benchmark on X": for real training it
times the jitted train step at the candidate batch size; for fleet planning it
evaluates the :class:`~repro_torch.core.topology.WorkerClass` analytic model.  Both
paths share this exact loop.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.topology import Fleet, WorkerClass

# benchmark(class_name, batch) -> seconds per step
BenchmarkFn = Callable[[str, int], float]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    batches: Dict[str, int]          # class name -> tuned batch size
    step_times: Dict[str, float]     # measured step time at tuned batch
    throughputs: Dict[str, float]    # samples/s per *single* worker of class
    reference_class: str             # the slowest class that anchored the tune
    margin: float                    # 1/E sync margin actually applied

    @property
    def global_batch(self) -> int:
        return sum(self.batches.values())

    def imbalance(self) -> float:
        """Max relative step-time spread across classes (0 = perfect)."""
        ts = [t for t in self.step_times.values() if math.isfinite(t)]
        if len(ts) < 2:
            return 0.0
        return (max(ts) - min(ts)) / max(ts)


def default_candidate_batches(max_batch: int) -> List[int]:
    """The paper's 'list of BS': powers of two up to the DRAM limit."""
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return out or [1]


def analytic_benchmark(fleet: Fleet) -> BenchmarkFn:
    """Benchmark callback backed by the worker-class analytic model."""

    def bench(name: str, batch: int) -> float:
        return fleet.by_name(name).step_time(batch)

    return bench


def measured_benchmark(
    step_fns: Dict[str, Callable[[int], None]], repeats: int = 3
) -> BenchmarkFn:
    """Benchmark callback that times real (jitted) step functions.

    ``step_fns[name](batch)`` must run one full training step at ``batch``
    and block until complete (caller wraps block_until_ready).
    """

    def bench(name: str, batch: int) -> float:
        fn = step_fns[name]
        fn(batch)  # warmup / compile
        t0 = _time.perf_counter()
        for _ in range(repeats):
            fn(batch)
        return (_time.perf_counter() - t0) / repeats

    return bench


def tune(
    fleet: Fleet,
    benchmark: Optional[BenchmarkFn] = None,
    *,
    C: float = 10.0,
    E: float = 5.0,
    candidates: Optional[Dict[str, Sequence[int]]] = None,
    max_iters: int = 64,
) -> TuneResult:
    """Algorithm 1 generalized from (host, newport) to N worker classes.

    C: batch-size update granularity (paper: constant; larger = finer).
    E: margin scale; the target step time for fast classes is
       ``time_slow * (1 - 1/E)`` (paper: fixed 20% margin -> E = 5).
    """
    benchmark = benchmark or analytic_benchmark(fleet)
    candidates = candidates or {}

    # --- step 1: sweep the slowest class (the paper's "Newport" role) -------
    slow = fleet.slowest()
    best_bs, best_tput, best_time = 1, 0.0, math.inf
    for bs in candidates.get(slow.name, default_candidate_batches(slow.max_batch)):
        if bs > slow.max_batch:
            continue  # DRAM saturation: the paper rejects these outright
        t = benchmark(slow.name, bs)
        tput = bs / t if t > 0 else 0.0
        if tput > best_tput:
            best_bs, best_tput, best_time = bs, tput, t
    batches = {slow.name: best_bs}
    times = {slow.name: best_time}

    # --- step 2: grow every faster class until its time exceeds time_slow by
    # the 1/E sync margin (paper loop: while (t_fast - t_slow) < t_slow/E) ----
    target = best_time * (1.0 + 1.0 / E)
    for cls in fleet.classes:
        if cls.name == slow.name:
            continue
        bs = max(1, batches.get(cls.name, 1))
        t = benchmark(cls.name, bs)
        for _ in range(max_iters):
            if (t - best_time) >= best_time / E or bs >= cls.max_batch:
                break
            # paper: BS_host += BS_host * (time_newport - time_host) / C,
            # normalized by the current time so C is shape-independent.
            grow = max(1, int(bs * (target - t) / (max(t, 1e-9) * C)))
            bs = min(cls.max_batch, bs + grow)
            t = benchmark(cls.name, bs)
        # gross overshoot from a large discrete step: back off toward target
        while t > target * 1.25 and bs > 1:
            bs = max(1, bs - max(1, bs // 16))
            t = benchmark(cls.name, bs)
        batches[cls.name] = bs
        times[cls.name] = t

    tputs = {
        n: (batches[n] / times[n] if times[n] > 0 and math.isfinite(times[n]) else 0.0)
        for n in batches
    }
    return TuneResult(
        batches=batches,
        step_times=times,
        throughputs=tputs,
        reference_class=slow.name,
        margin=1.0 / E,
    )


# ---------------------------------------------------------------------------
# Online re-tuning (beyond paper: the paper tunes once, offline)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DriftMonitor:
    """EWMA per-class step-time monitor driving *online* re-tunes.

    The trainer feeds observed per-class step times; when the spread between
    the fastest and slowest class exceeds the tuner's ``1/E`` margin for
    ``patience`` consecutive steps, it requests a re-tune.  Because hetero
    batches are realized as masks over a fixed-shape global batch
    (:mod:`repro_torch.core.hetero`), a re-tune never changes tensor shapes and so
    never triggers recompilation — that is what makes online re-tuning viable.
    """

    margin: float = 0.2
    alpha: float = 0.1
    patience: int = 10
    ewma: Dict[str, float] = dataclasses.field(default_factory=dict)
    _breach: int = 0

    def update(self, step_times: Dict[str, float]) -> bool:
        """Returns True when a re-tune should run."""
        for k, v in step_times.items():
            prev = self.ewma.get(k)
            self.ewma[k] = v if prev is None else (1 - self.alpha) * prev + self.alpha * v
        if len(self.ewma) < 2:
            return False
        ts = list(self.ewma.values())
        spread = (max(ts) - min(ts)) / max(max(ts), 1e-9)
        if spread > self.margin:
            self._breach += 1
        else:
            self._breach = 0
        if self._breach >= self.patience:
            self._breach = 0
            return True
        return False
