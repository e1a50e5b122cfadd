"""Serving steps (port of ``make_serve_step``/``make_prefill_step`` from
:mod:`repro.train.steps`).  Training steps come with the training slice."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.api import Model


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
