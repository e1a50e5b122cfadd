"""Heterogeneous synchronous data parallelism (contribution C4), port of
:mod:`repro.core.hetero`: the schedule is numpy, the loss is torch.

The paper gives each worker a literally different batch size (Horovod processes
are independent programs).  Under ``pjit`` every device must run ONE program
with uniform shapes, so unequal batches are realized as a *mask* over a
fixed-shape global batch:

    global batch layout: (n_groups * max_local, ...)   # rows grouped by dp-group
    validity:            row r is valid iff (r mod max_local) < batch(group(r))

The loss is ``Σ mask·loss / Σ mask`` — summed and normalized GLOBALLY — so the
gradient equals exactly the gradient of the union of all valid samples.  That
makes masked-uniform batches *numerically identical* to true unequal batches
(property-tested), while remaining one XLA program whose shapes never change
when the tuner adjusts batch shares (only mask contents change -> no
recompilation, which is what makes online re-tuning free).

Padding cost: invalid rows still burn FLOPs.  The pad fraction is
``1 - mean(batch_g)/max(batch_g)``, i.e. exactly the heterogeneity spread —
and Algorithm 1 exists to keep the *time* spread near zero, so in a tuned
fleet the fast groups have full rows and slow groups have few, making the
wasted FLOPs the same FLOPs the hardware could not have used anyway (they
would be spent waiting at the allreduce barrier).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BatchSchedule:
    """Fixed-shape realization of per-group tuned batch sizes.

    group_batches[g] = tuned batch for dp-group g (from Algorithm 1).
    max_local       = row capacity per group = max(group_batches) rounded up
                      to ``round_to`` (sharding-friendly).
    """

    group_batches: Tuple[int, ...]
    round_to: int = 1
    capacity: Optional[int] = None   # pinned row capacity (survives re-tunes)

    @property
    def n_groups(self) -> int:
        return len(self.group_batches)

    @property
    def max_local(self) -> int:
        m = max(self.group_batches) if self.group_batches else 0
        r = self.round_to
        m = ((m + r - 1) // r) * r
        return max(m, self.capacity or 0)

    @property
    def global_rows(self) -> int:
        """Padded global batch (rows in the SPMD program)."""
        return self.n_groups * self.max_local

    @property
    def valid_rows(self) -> int:
        return sum(self.group_batches)

    @property
    def pad_fraction(self) -> float:
        if self.global_rows == 0:
            return 0.0
        return 1.0 - self.valid_rows / self.global_rows

    def row_mask(self) -> np.ndarray:
        """(global_rows,) float32 validity mask, group-major layout."""
        m = np.zeros((self.n_groups, self.max_local), np.float32)
        for g, b in enumerate(self.group_batches):
            m[g, :b] = 1.0
        return m.reshape(-1)

    def with_batches(self, group_batches: Sequence[int]) -> "BatchSchedule":
        """Re-tune: new shares; the row capacity is pinned to the current
        ``max_local`` so shapes (and the compiled step) survive whenever the
        new batches fit.  Growth beyond capacity recompiles (rare by design)."""
        nb = tuple(int(b) for b in group_batches)
        return BatchSchedule(
            group_batches=nb, round_to=self.round_to,
            capacity=max(self.max_local,
                         BatchSchedule(nb, round_to=self.round_to).max_local),
        )


def masked_mean_loss(
    per_token_loss: torch.Tensor,   # (B, S) float
    loss_mask: torch.Tensor,        # (B, S) float — row validity x token validity
) -> torch.Tensor:
    """Global weighted mean: Σ mask·loss / Σ mask."""
    num = torch.sum(per_token_loss * loss_mask)
    den = torch.clamp(torch.sum(loss_mask), min=1.0)
    return num / den


def schedule_from_tune(
    tuned_batches: Dict[str, int],
    class_counts: Dict[str, int],
    *,
    round_to: int = 1,
) -> Tuple[BatchSchedule, List[str]]:
    """Expand per-CLASS tuned batches into per-GROUP schedule + group labels.

    Each physical worker of a class becomes one dp-group with that class's
    tuned batch (the paper's 24 CSDs are 24 identical groups + 1 host group).
    """
    group_batches: List[int] = []
    labels: List[str] = []
    for name in sorted(tuned_batches):
        for i in range(class_counts.get(name, 1)):
            group_batches.append(tuned_batches[name])
            labels.append(f"{name}/{i}")
    return BatchSchedule(tuple(group_batches), round_to=round_to), labels
