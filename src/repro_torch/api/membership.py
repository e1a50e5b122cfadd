"""Membership watching: observed process join/death -> elastic fleet events
(a copy of the framework-free :mod:`repro.api.membership`).

HyperTune-style elasticity needs a *membership source* — some ground truth
about which worker processes are alive — and a converter from membership
deltas to the session's :mod:`~repro_torch.api.events` vocabulary.  This module
is that converter, deliberately split in three pluggable pieces:

  * a **source** (:class:`DirMembershipSource`, or anything matching
    :class:`MembershipSource`) answers "who is alive right now".  The
    directory source reads heartbeat files worker processes refresh every
    few hundred ms; a process that dies (including SIGKILL — nothing to
    trap) simply stops refreshing and goes stale.  Swap in an etcd/k8s
    watcher by implementing ``poll()``.
  * a **watcher** (:class:`MembershipWatcher`) diffs successive polls into
    ``WorkerLost`` / ``WorkerJoined`` events — the SAME events every other
    elastic path uses, so membership-driven replanning exercises zero new
    session code.
  * a **controller** (:class:`ElasticController`) routes those events
    through ``session.apply()``; with a checkpoint directory configured, the
    next ``session.run()`` resumes the newest checkpoint on the replanned
    session.

The worker side is :class:`HeartbeatWriter`, a daemon thread that refreshes
a process's heartbeat for its whole life (the cluster runtime that starts
it comes with ROADMAP item 13).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Protocol, Tuple

from repro_torch.api.events import FleetEvent, WorkerJoined, WorkerLost

_SUFFIX = ".member.json"


@dataclasses.dataclass(frozen=True)
class MemberInfo:
    """One live member as reported by a membership source."""

    member: str                        # membership id (e.g. "proc-1")
    workers: Tuple[str, ...]           # dp-group workers it hosts
    pid: int = 0
    heartbeat: float = 0.0             # source timestamp of the last beat

    @property
    def class_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for w in self.workers:
            cls = w.rsplit("/", 1)[0]
            out[cls] = out.get(cls, 0) + 1
        return out


class MembershipSource(Protocol):
    """Anything that can answer "who is alive right now"."""

    def poll(self) -> Dict[str, MemberInfo]:
        """Current live members, keyed by member id."""
        ...


def write_heartbeat(
    directory: str, member: str, workers: Tuple[str, ...], pid: int
) -> str:
    """Refresh ``member``'s heartbeat file (atomic rename; mtime is the
    liveness signal, the JSON body is the custody claim)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, member + _SUFFIX)
    tmp = path + f".tmp{pid}"
    with open(tmp, "w") as f:
        json.dump({
            "member": member,
            "workers": list(workers),
            "pid": pid,
            "time": time.time(),
        }, f)
    os.replace(tmp, path)
    return path


class DirMembershipSource:
    """File/dir membership: one heartbeat file per member, freshness by
    mtime.  A member is alive iff its file's mtime is within
    ``stale_after`` seconds — a killed process stops beating and ages out;
    a cleanly leaving process may also just delete its file.
    """

    def __init__(self, directory: str, *, stale_after: float = 2.0):
        self.directory = directory
        self.stale_after = float(stale_after)

    def poll(self) -> Dict[str, MemberInfo]:
        out: Dict[str, MemberInfo] = {}
        if not os.path.isdir(self.directory):
            return out
        now = time.time()
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(_SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            try:
                mtime = os.path.getmtime(path)
                if now - mtime > self.stale_after:
                    continue
                with open(path) as f:
                    body = json.load(f)
                info = MemberInfo(
                    member=body["member"],
                    workers=tuple(body.get("workers", ())),
                    pid=int(body.get("pid", 0)),
                    heartbeat=mtime,
                )
                out[info.member] = info
            except (OSError, ValueError, KeyError):
                continue           # torn write / vanished mid-poll: not alive
        return out


class HeartbeatWriter:
    """Worker-side daemon thread refreshing this process's heartbeat."""

    def __init__(
        self,
        directory: str,
        member: str,
        workers: Tuple[str, ...],
        *,
        interval: float = 0.25,
    ):
        self.directory = directory
        self.member = member
        self.workers = tuple(workers)
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatWriter":
        write_heartbeat(self.directory, self.member, self.workers, os.getpid())

        def beat():
            while not self._stop.wait(self.interval):
                try:
                    write_heartbeat(
                        self.directory, self.member, self.workers, os.getpid()
                    )
                except OSError:
                    return
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()
        return self

    def stop(self, *, deregister: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval * 4)
        if deregister:
            try:
                os.remove(
                    os.path.join(self.directory, self.member + _SUFFIX)
                )
            except OSError:
                pass


class MembershipWatcher:
    """Diff successive membership polls into elastic fleet events.

    The FIRST poll establishes the baseline (starting a watcher next to a
    running cluster must not replay the whole fleet as joins) unless the
    expected membership is given up front via ``baseline``.  After that,
    every vanished member yields one ``WorkerLost`` with its workers, and
    every new member yields ``WorkerJoined`` per worker class it hosts.
    """

    def __init__(
        self,
        source: MembershipSource,
        *,
        baseline: Optional[Dict[str, MemberInfo]] = None,
    ):
        self.source = source
        self._known: Optional[Dict[str, MemberInfo]] = (
            dict(baseline) if baseline is not None else None
        )

    @property
    def known(self) -> Dict[str, MemberInfo]:
        return dict(self._known or {})

    def events(self) -> List[FleetEvent]:
        """Poll once; return the fleet events since the previous poll."""
        live = self.source.poll()
        if self._known is None:
            self._known = live
            return []
        out: List[FleetEvent] = []
        for member in sorted(set(self._known) - set(live)):
            workers = self._known[member].workers
            if workers:
                out.append(WorkerLost(workers))
        for member in sorted(set(live) - set(self._known)):
            for cls, count in sorted(live[member].class_counts.items()):
                out.append(WorkerJoined(cls, count))
        self._known = live
        return out

    def wait_for(
        self, n_members: int, *, timeout: float = 30.0, interval: float = 0.1
    ) -> Dict[str, MemberInfo]:
        """Block until ``n_members`` are alive (cluster start barrier)."""
        deadline = time.time() + timeout
        while True:
            live = self.source.poll()
            if len(live) >= n_members:
                if self._known is None:
                    self._known = live
                return live
            if time.time() > deadline:
                raise TimeoutError(
                    f"{len(live)}/{n_members} members after {timeout}s"
                )
            time.sleep(interval)


class ElasticController:
    """Membership events -> ``session.apply()`` -> checkpoint-coordinated
    restore, in one ``step()`` the control loop calls on a timer.

    The controller holds the FULL fleet view (it is the coordinator's
    session, not a worker's): applying ``WorkerLost`` shrinks the plan; the
    newest checkpoint then restores onto the resized session through
    ``session.run()``'s standard resume path — no bespoke elastic restore
    code.
    """

    def __init__(self, session, watcher: MembershipWatcher):
        self.session = session
        self.watcher = watcher
        self.applied: List[FleetEvent] = []

    def step(self) -> List:
        """Poll membership once and replan for every event observed."""
        results = []
        for event in self.watcher.events():
            try:
                results.append(self.session.apply(event))
                self.applied.append(event)
            except (KeyError, ValueError):
                # a member the session never planned for (e.g. lost before
                # its join was applied) — membership and plan re-converge
                # on the next poll
                continue
        return results
