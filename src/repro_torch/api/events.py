"""Elastic fleet events — the ONE way session state changes mid-run.

The seed trainer had three divergent mutation paths (``retune``,
``drop_workers``, and nothing at all for growth).  Here every elastic change
is an event applied through :meth:`repro_torch.api.Session.apply`, which funnels
all three into a single replanning code path:

  * :class:`WorkerLost`    — node failure: dp-groups removed, the dead
    workers' private shards are gone (privacy constraint: nobody else may
    read them), survivors re-plan with the paper's backfill remedy.
  * :class:`WorkerJoined`  — elastic growth: a class gains workers and the
    whole pipeline re-tunes around the new counts.
  * :class:`DriftDetected` — step-time spread breached the tuner's 1/E
    margin: re-tune batch shares in place.  Shapes are pinned to the current
    row capacity, so this never recompiles.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """Base class for all elastic events (see subclasses)."""


@dataclasses.dataclass(frozen=True)
class WorkerLost(FleetEvent):
    """One or more physical workers (e.g. ``"csd/1"``) died."""

    workers: Tuple[str, ...]

    def __init__(self, workers: Sequence[str]):
        if isinstance(workers, str):
            workers = (workers,)
        object.__setattr__(self, "workers", tuple(workers))


@dataclasses.dataclass(frozen=True)
class WorkerJoined(FleetEvent):
    """``count`` new workers of an existing class came online."""

    class_name: str
    count: int = 1

    def __post_init__(self):
        if self.count <= 0:
            raise ValueError(f"WorkerJoined.count must be positive, "
                             f"got {self.count}")


@dataclasses.dataclass(frozen=True)
class DriftDetected(FleetEvent):
    """Per-class step times drifted past the tune margin; re-tune shares."""

    source: str = "manual"        # "monitor" when raised by the DriftMonitor
