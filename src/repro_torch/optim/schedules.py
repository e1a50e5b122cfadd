"""LR schedules (port of :mod:`repro.optim.schedules`).  The paper (§IV,
citing Goyal et al. 2017) preserves accuracy under distribution via (a)
linear LR scaling with the global batch and (b) a warmup that ramps from a
low LR.  Each schedule maps an int step to a 0-d float32 tensor on the CPU,
computed in float32 as the reference computes it.
"""
from __future__ import annotations

from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]  # step -> lr


def linear_scaled_lr(base_lr: float, global_batch: int, base_batch: int = 256) -> float:
    """Goyal linear scaling rule: lr = base_lr * global_batch / base_batch."""
    return base_lr * global_batch / base_batch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def goyal_schedule(
    base_lr: float,
    global_batch: int,
    *,
    base_batch: int = 256,
    warmup_steps: int = 500,
    total_steps: int = 100_000,
    final_frac: float = 0.1,
) -> Schedule:
    """Warmup from base_lr -> scaled lr over ``warmup_steps`` (gradual warmup),
    then linear decay to ``final_frac`` of the scaled LR."""
    peak = linear_scaled_lr(base_lr, global_batch, base_batch)

    def lr(step):
        step = _step_f32(step)
        warm = base_lr + (peak - base_lr) * torch.clamp(step / max(1, warmup_steps), max=1.0)
        frac = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0
        )
        decay = peak * (1.0 - (1.0 - final_frac) * frac)
        return torch.where(step < warmup_steps, warm, decay)

    return lr

