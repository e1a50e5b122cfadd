"""Privacy-constrained data placement (paper contribution C3).

In the paper, private data lives on a CSD's flash and *never* crosses the
NVMe/host boundary; only public data is shared between host and CSDs.  On a
TPU fleet the analogue is pod-local (or dp-group-local) residency: a private
shard is pinned to its home dp-group and is only ever read by that group's
input pipeline.

This module produces an explicit, auditable *placement manifest*; the storage
layer (:mod:`repro_torch.storage`) refuses to materialize a private shard on any
device other than its owner's — every backend's custody guard is the
enforcement point, mirroring how the paper's ISP engine is the only thing
that can touch flash.  Custody *changes* (re-homes after a node loss,
quarantines of a dead owner's privates) are logged as :class:`CustodyEvent`
records; :func:`audit_custody` is the machine check that no private shard
ever moved.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Shard:
    shard_id: str
    n_samples: int
    private: bool
    owner: Optional[str] = None      # required iff private

    def __post_init__(self):
        if self.private and self.owner is None:
            raise ValueError(f"private shard {self.shard_id!r} needs an owner")


@dataclasses.dataclass(frozen=True)
class Assignment:
    worker: str
    shard_id: str
    n_samples: int                   # samples drawn from this shard
    private: bool


@dataclasses.dataclass(frozen=True)
class PlacementManifest:
    assignments: Tuple[Assignment, ...]

    def for_worker(self, worker: str) -> List[Assignment]:
        return [a for a in self.assignments if a.worker == worker]

    def validate(self, shards: Mapping[str, Shard]) -> None:
        """Raise if any private shard is read by a non-owner (the invariant)."""
        for a in self.assignments:
            s = shards[a.shard_id]
            if s.private and a.worker != s.owner:
                raise PermissionError(
                    f"private shard {s.shard_id!r} (owner {s.owner!r}) "
                    f"assigned to {a.worker!r}"
                )

    def totals(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for a in self.assignments:
            out[a.worker] = out.get(a.worker, 0) + a.n_samples
        return out


def place(
    shards: Sequence[Shard],
    worker_targets: Mapping[str, int],   # worker -> samples/epoch (from Eq.1 plan)
) -> PlacementManifest:
    """Assign shards to workers honoring privacy.

    Private shards go whole to their owners (up to the owner's target).
    Public shards are split greedily across workers still short of target.
    """
    by_id = {s.shard_id: s for s in shards}
    remaining = dict(worker_targets)
    assigns: List[Assignment] = []

    # 1. private first — pinned, possibly truncated to the owner's target
    for s in shards:
        if not s.private:
            continue
        tgt = remaining.get(s.owner, 0)
        take = min(s.n_samples, tgt)
        if take > 0:
            assigns.append(Assignment(s.owner, s.shard_id, take, True))
            remaining[s.owner] = tgt - take

    # 2. public fills the gaps, split across workers
    for s in shards:
        if s.private:
            continue
        left = s.n_samples
        for w in sorted(remaining, key=lambda w: -remaining[w]):
            if left <= 0:
                break
            take = min(left, remaining[w])
            if take > 0:
                assigns.append(Assignment(w, s.shard_id, take, False))
                remaining[w] -= take
                left -= take

    manifest = PlacementManifest(assignments=tuple(assigns))
    manifest.validate(by_id)
    return manifest


@dataclasses.dataclass(frozen=True)
class CustodyEvent:
    """One auditable custody change in the device fleet.

    ``kind``: "provision" (a device came up holding the shard), "rehome"
    (a public shard's custodian died; a survivor took over), or
    "quarantine" (a private shard's owner died; the bytes are tombstoned).
    """

    kind: str
    shard_id: str
    private: bool
    src: Optional[str] = None     # previous custodian (None on provision)
    dst: Optional[str] = None     # new custodian (None on quarantine)

    def __post_init__(self):
        if self.kind not in ("provision", "rehome", "quarantine"):
            raise ValueError(f"unknown custody event kind {self.kind!r}")


def audit_custody(log: Sequence[CustodyEvent]) -> Dict[str, int]:
    """The paper's privacy claim over the custody log: private shards may be
    provisioned (to their owner) or quarantined, NEVER re-homed.

    Beyond the headline re-home count, two log pathologies are flagged:

    * ``private_shards_resurrected`` — a private shard provisioned *after*
      it was quarantined: tombstoned bytes coming back to life means some
      device re-materialized data whose owner is gone.
    * ``duplicate_provisions`` — the same shard provisioned twice to the
      same custodian with no intervening custody change: double-counted
      custody makes the rest of the log unauditable.
    """
    moved = 0
    resurrected = 0
    duplicates = 0
    quarantined: set = set()
    live: set = set()                 # (shard_id, custodian) currently held
    for e in log:
        if e.kind == "rehome":
            if e.private:
                moved += 1
            live.discard((e.shard_id, e.src))
            live.add((e.shard_id, e.dst))
        elif e.kind == "quarantine":
            quarantined.add(e.shard_id)
            live = {lv for lv in live if lv[0] != e.shard_id}
        elif e.kind == "provision":
            if e.private and e.shard_id in quarantined:
                resurrected += 1
            if (e.shard_id, e.dst) in live:
                duplicates += 1
            live.add((e.shard_id, e.dst))
    return {
        "private_shards_rehomed": moved,
        "private_shards_resurrected": resurrected,
        "duplicate_provisions": duplicates,
    }


def leakage_report(
    manifest: PlacementManifest, shards: Mapping[str, Shard]
) -> Dict[str, int]:
    """Bytes-equivalent of the paper's privacy claim: count private samples
    that would transit the interconnect (must be 0 by construction)."""
    leaked = 0
    for a in manifest.assignments:
        s = shards[a.shard_id]
        if s.private and a.worker != s.owner:
            leaked += a.n_samples
    return {"private_samples_moved": leaked}
