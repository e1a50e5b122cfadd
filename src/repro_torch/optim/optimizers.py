"""SGD-momentum and AdamW (port of :mod:`repro.optim.optimizers`).

The update formulas are the reference's, term for term: f32 moments, the
``b ** t`` bias correction taken in f32, weight decay inside the step, and
``(p.f32 - lr * step).to(p.dtype)``.  ``torch.optim.AdamW`` decays the
weights in a separate multiply and would not match.

Unlike the JAX package, which returns fresh trees and donates the old
buffers, ``update`` writes the new moments and parameters IN PLACE into the
tensors it is given (and returns them): at deepseek-7b width a second copy
of params + moments would not fit beside the first on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

PyTree = Any


class OptState(NamedTuple):
    step: int                # updates applied so far
    mu: PyTree               # first moment / momentum (f32)
    nu: Optional[PyTree]     # second moment (None for SGD)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state;  update(grads, state, params, lr) -> (new_state, new_params)."""

    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree, torch.Tensor], Tuple[OptState, PyTree]]


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """Leaves of a nested dict in insertion order (the tree's one order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _zeros_like_f32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def sgd_momentum(momentum: float = 0.9, nesterov: bool = False,
                 weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=_zeros_like_f32(params), nu=None)

    @torch.no_grad()
    def update(grads, state, params, lr):
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(params)):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            m.copy_(momentum * m + g)
            d = g + momentum * m if nesterov else m
            p.copy_((p.float() - lr * d).to(p.dtype))
        return OptState(step=state.step + 1, mu=state.mu, nu=None), params

    return Optimizer(init=init, update=update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return OptState(step=0, mu=_zeros_like_f32(params), nu=_zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state, params, lr):
        leaves = tree_leaves(params)
        t = _f32(state.step + 1, leaves[0])
        c1 = 1.0 - torch.pow(_f32(b1, leaves[0]), t)
        c2 = 1.0 - torch.pow(_f32(b2, leaves[0]), t)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), leaves):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            step = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
        return OptState(step=state.step + 1, mu=state.mu, nu=state.nu), params

    return Optimizer(init=init, update=update)
