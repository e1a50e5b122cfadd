"""Typed callback registry for the Session lifecycle.

Replaces the seed trainer's single ``on_metrics`` lambda with named hooks.
Registration methods double as decorators:

    cb = CallbackRegistry()

    @cb.on_step
    def log(step, metrics):
        print(step, metrics["loss"])

    cb.on_fleet_change(lambda event, result: alerting.page(event))
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

OnStep = Callable[[int, Dict[str, float]], None]          # (step, metrics)
OnRetune = Callable[[Any, Any], None]                     # (event, tune_plan)
OnCheckpoint = Callable[[int, str], None]                 # (step, directory)
OnFleetChange = Callable[[Any, Any], None]                # (event, replan_result)


@dataclasses.dataclass
class CallbackRegistry:
    _step: List[OnStep] = dataclasses.field(default_factory=list)
    _retune: List[OnRetune] = dataclasses.field(default_factory=list)
    _checkpoint: List[OnCheckpoint] = dataclasses.field(default_factory=list)
    _fleet_change: List[OnFleetChange] = dataclasses.field(default_factory=list)

    # -- registration (usable as decorators) -------------------------------

    def on_step(self, fn: OnStep) -> OnStep:
        self._step.append(fn)
        return fn

    def on_retune(self, fn: OnRetune) -> OnRetune:
        self._retune.append(fn)
        return fn

    def on_checkpoint(self, fn: OnCheckpoint) -> OnCheckpoint:
        self._checkpoint.append(fn)
        return fn

    def on_fleet_change(self, fn: OnFleetChange) -> OnFleetChange:
        self._fleet_change.append(fn)
        return fn

    # -- unsubscription -----------------------------------------------------

    def remove_on_step(self, fn: OnStep) -> None:
        self._step.remove(fn)

    # -- emission (called by the Session) ----------------------------------

    def emit_step(self, step: int, metrics: Dict[str, float]) -> None:
        for fn in self._step:
            fn(step, metrics)

    def emit_retune(self, event: Any, tune_plan: Any) -> None:
        for fn in self._retune:
            fn(event, tune_plan)

    def emit_checkpoint(self, step: int, directory: str) -> None:
        for fn in self._checkpoint:
            fn(step, directory)

    def emit_fleet_change(self, event: Any, result: Any) -> None:
        for fn in self._fleet_change:
            fn(event, result)
