"""Train / eval / serve step factories (port of :mod:`repro.train.steps`).

``make_train_step`` builds the masked-weighted-loss training step
(:mod:`repro_torch.core.hetero` semantics): per-token CE, multiplied by the
combined row-validity x token mask, summed and normalized GLOBALLY, so
heterogeneous group batch sizes are numerically exact.  ``make_serve_step``
builds the one-token KV-cache decode step.

The reference's abstract train state and ``build_sharding_plan`` resolve a
rule table against a mesh; the port runs on one device and has neither
(the session's one-device plan lives in :mod:`repro_torch.api.artifacts`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.hetero import masked_mean_loss
from repro_torch.models.api import Model
from repro_torch.optim.optimizers import Optimizer, OptState, tree_leaves, tree_map

PyTree = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE, numerically stable. logits (B,S,V) f32/bf16; labels (B,S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def loss_fn(
    model: Model,
    params: PyTree,
    batch: Dict[str, torch.Tensor],
    *,
    aux_weight: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked global-mean LM loss (+ router aux for MoE)."""
    logits, aux = model.forward(params, batch["tokens"])
    ce = cross_entropy(logits, batch["labels"])
    mask = batch["loss_mask"]
    loss = masked_mean_loss(ce, mask)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": torch.sum(mask)}


def value_and_grad(
    model: Model, params: PyTree, batch: Dict[str, torch.Tensor], *, aux_weight: float = 0.01,
) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]], PyTree]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((total, parts), grads),
    grads a tree shaped like ``params``.  ``params`` are not modified."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, parts = loss_fn(model, live, batch, aux_weight=aux_weight)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    return (total.detach(), {k: v.detach() for k, v in parts.items()}), \
        tree_map(lambda _: next(it), live)


def make_train_step(
    model: Model,
    optimizer: Optimizer,
    lr_schedule: Callable[[int], torch.Tensor],
    *,
    aux_weight: float = 0.01,
    grad_transform: Optional[Callable[[PyTree], PyTree]] = None,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    The optimizer updates ``params`` and the moments in place (the JAX
    package donates them) and the step returns the same tensors.  Metrics
    are 0-d tensors: loss, aux, total, lr, grad_norm (the square root of the
    float32 sum of squares of every gradient) and tokens.
    """

    def train_step(params, opt_state: OptState, batch):
        (total, parts), grads = value_and_grad(model, params, batch, aux_weight=aux_weight)
        if grad_transform is not None:
            grads = grad_transform(grads)
        lr = lr_schedule(opt_state.step)
        opt_state, params = optimizer.update(grads, opt_state, params, lr)
        # elementwise square + sum per leaf, as the reference (not a vdot)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        metrics = {
            "loss": parts["loss"],
            "aux": parts["aux"],
            "total": total,
            "lr": lr,
            "grad_norm": gnorm,
            "tokens": parts["tokens"],
        }
        return params, opt_state, metrics

    return train_step


def residual_bytes(
    model: Model, params: PyTree, batch: Dict[str, torch.Tensor], *, aux_weight: float = 0.01,
) -> int:
    """Bytes of the tensors autograd saves for the backward of one loss.

    Counted through ``torch.autograd.graph.saved_tensors_hooks`` over a real
    forward on ``batch`` (the reference prices the same set by
    ``eval_shape`` of the vjp pullback): the footprint that
    ``train_precision="int8-fused"`` shrinks by saving K/V as int8 + per-row
    scales.  A tensor saved twice counts twice.
    """
    total = 0

    def pack(t: torch.Tensor) -> torch.Tensor:
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss_fn(model, live, batch, aux_weight=aux_weight)
    return total


def make_eval_step(model: Model, *, aux_weight: float = 0.01) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, parts = loss_fn(model, params, batch, aux_weight=aux_weight)
        return parts

    return eval_step


def make_serve_step(model: Model) -> Callable:
    """One-token decode: (params, token, cache, pos) -> (next_token, logits, cache).

    The cache is updated in place and returned."""

    def serve_step(params, token, cache, pos):
        logits, cache = model.decode_step(params, token, cache, pos)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], logits, cache

    return serve_step


def make_prefill_step(model: Model, cache_len: int) -> Callable:
    def prefill_step(params, tokens):
        return model.prefill(params, tokens, cache_len)

    return prefill_step
