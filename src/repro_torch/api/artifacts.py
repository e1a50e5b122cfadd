"""Frozen stage artifacts produced by the Session pipeline (port of
:mod:`repro.api.artifacts`).

Each pipeline stage returns one immutable artifact:

    Session.tune()    -> TunePlan            (Algorithm 1 + group schedule)
    Session.plan()    -> core EpochPlan      (Eq. 1 dataset shares)
    Session.place()   -> FleetManifest       (privacy placement, per device)
    Session.shard()   -> ShardingPlan        (one device in this port)
    Session.compile() -> CompiledStep        (the train step)
    Session.run()     -> TrainReport
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.hetero import BatchSchedule
from repro_torch.core.tuner import TuneResult

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TunePlan:
    """Algorithm-1 output expanded to physical dp-groups.

    ``schedule.capacity`` pins the row capacity: re-tunes that fit under it
    keep the compiled step's shapes (and therefore never recompile).
    """

    result: TuneResult
    schedule: BatchSchedule
    group_workers: Tuple[str, ...]

    @property
    def batches(self) -> Dict[str, int]:
        return self.result.batches


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Where the step's state and batches live: one torch device.

    The reference resolves a logical-axis rule table against a device mesh
    into ``NamedSharding`` trees (``repro/distributed/sharding.py``, JAX
    only); on one card every leaf and every batch key lives whole on
    ``device``.  Keyed by ``global_rows`` like the reference's plan.
    Multi-device plans come with the port's multi-device slice (ROADMAP
    item 13).
    """

    device: torch.device
    global_rows: int

    def describe(self) -> str:
        return f"ShardingPlan(device={self.device}, rows={self.global_rows})"


@dataclasses.dataclass(frozen=True)
class CompiledStep:
    """The train step plus the shape signature it was built for.

    ``build_id`` is the session-wide compile counter — the probe tests use
    to assert that a drift re-tune did NOT trigger a rebuild.
    """

    step_fn: Callable
    global_rows: int
    seq_len: int
    valid_rows: int           # lr-schedule anchor at build time
    build_id: int
    config_key: Tuple = ()    # the SessionConfig values baked into the step


@dataclasses.dataclass(frozen=True)
class TrainReport:
    """What a training run produced (``Session.run``'s return value).

    ``opt_state`` lets a caller continue training:
    ``session.run(report.params, opt_state=report.opt_state)`` keeps the
    optimizer moments and the lr-schedule step counter.
    """

    params: PyTree
    opt_state: Any
    history: Tuple[Dict[str, float], ...]
    steps_run: int
    start_step: int
    compile_count: int
    wall_time: float

    @property
    def final_loss(self) -> float:
        return self.history[-1]["loss"] if self.history else float("nan")


@dataclasses.dataclass(frozen=True)
class ReplanResult:
    """Outcome of ``Session.apply(event)`` — one per elastic event."""

    event: Any
    tune_plan: TunePlan
    recompiled: bool          # False => shapes survived, no rebuild
    dropped_shards: Tuple[str, ...] = ()
