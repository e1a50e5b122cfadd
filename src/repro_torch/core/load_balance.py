"""Epoch load balancing (paper Eq. 1) + the unequal-private-shard remedies.

Eq. 1:  steps_per_epoch = dataset / batchsize
        => dataset_host = dataset_card / batchsize_card * batchsize_host

i.e. after the tuner fixes per-class batch sizes, each worker's dataset share
is proportional to its batch size, so every worker finishes an epoch after the
SAME number of steps — no end-of-epoch stall of fast workers (paper §IV).

When private shards are unequal, the paper gives two remedies:
  * ``backfill``  — top up small-private workers with public data;
  * ``duplicate`` — replicate private data to reach the target share.
Both are implemented; the planner picks backfill while public data lasts, then
falls back to duplication (maximizing samples/sec as the paper prescribes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkerShare:
    worker: str                 # physical worker id, e.g. "newport/3"
    batch: int                  # tuned per-step batch size
    n_private: int              # private samples owned by (and pinned to) it
    n_public: int               # public samples assigned to it
    n_duplicated: int = 0       # private samples replayed to fill the share

    @property
    def total(self) -> int:
        return self.n_private + self.n_public + self.n_duplicated

    @property
    def steps(self) -> int:
        return self.total // max(1, self.batch)


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    shares: Tuple[WorkerShare, ...]
    steps_per_epoch: int
    public_left: int             # public samples not assigned anywhere

    def share_for(self, worker: str) -> WorkerShare:
        for s in self.shares:
            if s.worker == worker:
                return s
        raise KeyError(worker)

    def imbalance_steps(self) -> int:
        """Max spread in steps across workers (0 = everyone stops together)."""
        st = [s.steps for s in self.shares]
        return max(st) - min(st) if st else 0


def eq1_dataset_size(dataset_card: int, batch_card: int, batch_host: int) -> int:
    """Literal paper Eq. 1 (kept for tests / the Table-I benchmark)."""
    return int(dataset_card / batch_card * batch_host)


def plan_epoch(
    batches: Dict[str, int],           # worker id -> tuned batch size
    private_sizes: Dict[str, int],     # worker id -> private samples it owns
    n_public: int,                     # shared/public pool size
    *,
    allow_duplication: bool = True,
) -> EpochPlan:
    """Assign data so all workers finish an epoch in the same number of steps.

    steps* is chosen as the largest step count such that every worker's share
    can be met from (its private data) + (its slice of the public pool),
    maximizing utilization; workers short on private data are backfilled from
    the public pool and, if that runs dry and duplication is allowed, replay
    their own private data (never anyone else's — privacy constraint).
    """
    workers = sorted(batches)
    total_batch = sum(batches[w] for w in workers)
    total_private = sum(private_sizes.get(w, 0) for w in workers)
    if total_batch <= 0:
        return EpochPlan(shares=(), steps_per_epoch=0, public_left=n_public)

    # upper bound: all data used, perfectly proportional
    steps_hi = (total_private + n_public) // total_batch

    def feasible(steps: int) -> Optional[List[WorkerShare]]:
        """Try to realize ``steps`` for every worker; None if impossible."""
        need_pub: Dict[str, int] = {}
        for w in workers:
            want = steps * batches[w]
            have = min(private_sizes.get(w, 0), want)
            need_pub[w] = want - have
        if sum(need_pub.values()) <= n_public:
            pub = dict(need_pub)
            dup = {w: 0 for w in workers}
        elif allow_duplication:
            # backfill public proportionally to need, duplicate the rest
            pub, dup = {}, {}
            remaining = n_public
            total_need = sum(need_pub.values())
            for w in workers:
                p = min(need_pub[w], int(n_public * need_pub[w] / max(1, total_need)))
                pub[w] = p
                remaining -= p
            # hand out the integer remainder greedily
            for w in sorted(workers, key=lambda w: -(need_pub[w] - pub[w])):
                take = min(remaining, need_pub[w] - pub[w])
                pub[w] += take
                remaining -= take
                if remaining <= 0:
                    break
            for w in workers:
                short = need_pub[w] - pub[w]
                if short > 0 and private_sizes.get(w, 0) == 0:
                    return None  # nothing to duplicate from
                dup[w] = short
        else:
            return None
        out = []
        for w in workers:
            want = steps * batches[w]
            have_priv = min(private_sizes.get(w, 0), want)
            out.append(
                WorkerShare(
                    worker=w, batch=batches[w], n_private=have_priv,
                    n_public=pub[w], n_duplicated=dup[w],
                )
            )
        return out

    # binary search the largest feasible step count
    lo, hi, best = 0, steps_hi, None
    while lo <= hi:
        mid = (lo + hi) // 2
        got = feasible(mid)
        if got is not None:
            best, lo = got, mid + 1
        else:
            hi = mid - 1
    shares = best or []
    used_pub = sum(s.n_public for s in shares)
    steps = shares[0].steps if shares else 0
    return EpochPlan(
        shares=tuple(shares), steps_per_epoch=steps, public_left=n_public - used_pub
    )
