"""GPipe-style pipeline parallelism over a ``torch.distributed`` group
(port of :mod:`repro.distributed.pipeline`).

Schedule: GPipe fill-drain with M microbatches over S stages, one stage a
rank of the ``stage`` group; bubble fraction (S-1)/(M+S-1).  Every rank
holds the stacked stage parameters (leading dim S) and uses its own slice.
The time loop runs M + S - 1 ticks; each tick every stage

  1. computes on its current microbatch (garbage during fill/drain, never
     collected),
  2. sends its activation one stage on round the ring and receives the
     previous stage's (the reference's ``ppermute``).

Stage 0 injects microbatch t at tick t; stage S-1 collects microbatch t at
tick t + S - 1.  A final all-reduce broadcasts the collected outputs (zeros
on every other stage), as the reference's ``psum``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.allreduce import _peer, _shift
from repro_torch.optim.optimizers import tree_map

PyTree = Any


def pipeline_apply(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: PyTree,        # leaves stacked (S, ...): rank s uses slice s
    micro_in: torch.Tensor,      # (M, mb, ...) microbatched input activations
    *,
    group=None,
) -> torch.Tensor:
    """Run the GPipe schedule over ``group``'s ranks (``None``: the default
    group); ``stage_fn`` keeps its input's shape.  -> (M, mb, ...)
    final-stage outputs, on every rank."""
    S = dist.get_world_size(group)
    sid = dist.get_rank(group)
    M = micro_in.shape[0]
    params = tree_map(lambda a: a[sid], stage_params)
    nxt, prv = _peer(group, (sid + 1) % S), _peer(group, (sid - 1) % S)
    buf = torch.zeros_like(micro_in[0])             # in-flight activation
    outs = torch.zeros_like(micro_in)               # collected at the last stage
    for t in range(M + S - 1):
        x_in = micro_in[min(t, M - 1)] if sid == 0 else buf
        y = stage_fn(params, x_in)
        out_ix = t - (S - 1)
        if sid == S - 1 and out_ix >= 0:
            outs[out_ix] = y
        if S > 1:
            recv = torch.empty_like(y)
            _shift(y.contiguous(), recv, nxt, prv, group)
            buf = recv
    if S > 1:
        dist.all_reduce(outs, group=group)
    return outs


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...)"""
    B = x.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
