"""Optimizers and LR schedules (port of :mod:`repro.optim`): SGD-momentum
(the paper trains with SGD), AdamW (LM-standard), and the Goyal et al.
schedule the paper cites: linear LR scaling with the global batch size plus
gradual warmup."""
from repro_torch.optim.optimizers import OptState, Optimizer, adamw, sgd_momentum
from repro_torch.optim.schedules import goyal_schedule, linear_scaled_lr

__all__ = [
    "OptState", "Optimizer", "adamw", "sgd_momentum",
    "goyal_schedule", "linear_scaled_lr",
]
