"""Model-step programs of :class:`ServeEngine` (port of :mod:`repro.serve.runner`).

  * ``decode``: one batched token step over the engine's whole slot batch,
    with sampling and an ``active`` mask: inactive and mid-prefill slots keep
    their cache state bit for bit, so one fixed-shape step serves every mix
    of decoding, prefilling and empty slots.
  * ``extend``: the single-token ``decode_step`` looped over a token chunk,
    the reference's ``lax.scan`` of the same step written as a loop: the
    chunked-prefill primitive for every family.

The port's ``decode_step`` writes the cache in place (the JAX package
donates it and then selects, per slot, between the new and the old cache:
``mask_tree``).  In place, an inactive slot would lose what the step writes
for it at its stale position.  So ``decode`` saves exactly those values
before the step and puts them back after it (``Model.decode_writes``, which
each family defines beside its ``decode_step``), and runs the step over all
slots, as the reference does: a row's result then never depends on which
other rows are active (a matrix product's algorithm may change with its row
count).  Only the active rows sample, each from its own
request's generator, so a generator draws once per generated token.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serve.sampling import make_sample_fn

PyTree = Any


class StepRunner:
    """The decode/extend steps for one model."""

    def __init__(self, model: Model, *, k_cap: int = 64):
        self.model = model
        self.sample1 = make_sample_fn(k_cap)

    @torch.no_grad()
    def decode(self, params: PyTree, tok: torch.Tensor, cache: PyTree, pos: np.ndarray,
               active: np.ndarray, generators: Sequence[Optional[torch.Generator]],
               temp: np.ndarray, topk: np.ndarray) -> Tuple[torch.Tensor, PyTree]:
        """tok (S, 1) on the device; pos (S,), active (S,) bool, temp (S,) and
        topk (S,) on the host; one generator per active slot.  -> (next token
        (S,) int32 on the device, 0 where inactive; ``cache``, updated in place)."""
        S = tok.shape[0]
        idle = [int(s) for s in np.flatnonzero(~active)]
        writes = self.model.decode_writes(cache, pos, idle) if idle else []
        saved = [(leaf, at, leaf[at]) for leaf, at in writes]
        pos_t = torch.from_numpy(np.asarray(pos, np.int32)).to(tok.device)
        logits, cache = self.model.decode_step(params, tok, cache, pos_t)
        for leaf, at, old in saved:
            leaf[at] = old
        nxt = torch.zeros((S,), dtype=torch.int32, device=tok.device)
        rows = np.flatnonzero(active)
        if len(rows):
            sel = torch.from_numpy(rows).to(tok.device)
            nxt[sel] = self.sample1(logits[sel, -1], [generators[r] for r in rows],
                                    torch.from_numpy(temp[rows]), torch.from_numpy(topk[rows]))
        return nxt, cache

    @torch.no_grad()
    def extend(self, params: PyTree, tokens: torch.Tensor, cache: PyTree,
               start: int) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B, C) from position ``start`` -> (last logits (B, V),
        ``cache`` updated in place)."""
        B, C = tokens.shape
        for t in range(C):
            pos = torch.full((B,), start + t, dtype=torch.int32, device=tokens.device)
            logits, cache = self.model.decode_step(params, tokens[:, t:t + 1], cache, pos)
        return logits[:, -1], cache
