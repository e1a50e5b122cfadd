"""Synthetic-user load generator + latency accounting for :class:`ServeEngine`
(a copy of :mod:`repro.serve.loadgen` over the port's engine).

Closed-loop load: ``n_requests`` synthetic users all submit up-front (so the
queue depth — the number of concurrently outstanding requests — equals
``n_requests``) and the engine drains them through its slot batch.  Per-request
latency is submit→finish wall clock, which under a deep queue is dominated by
queueing: the regime the p99 numbers expose.

``shared_prefix_len`` > 0 gives every prompt a common prefix (a system
prompt), exercising the prefix cache under load.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.serve.engine import ServeEngine


def percentile(xs: List[float], p: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), p))


@dataclasses.dataclass
class LoadReport:
    arch: str
    family: str
    n_requests: int
    concurrency: int            # outstanding requests at peak (closed loop: all)
    prompt_len: int
    max_new_tokens: int
    wall_s: float
    requests_per_s: float
    decode_tok_s: float
    latency_p50_ms: float
    latency_p99_ms: float
    ttft_p50_ms: float
    ttft_p99_ms: float
    engine_steps: int
    prefix_hit_rate: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def run_load(
    engine: ServeEngine,
    *,
    n_requests: int,
    prompt_len: int = 16,
    max_new_tokens: int = 8,
    shared_prefix_len: int = 0,
    vocab: Optional[int] = None,
    seed: int = 0,
) -> LoadReport:
    vocab = vocab or engine.model.cfg.vocab
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=(shared_prefix_len,)).tolist()
    prompts = [
        prefix + rng.integers(
            0, vocab, size=(prompt_len - shared_prefix_len,)
        ).tolist()
        for _ in range(n_requests)
    ]

    t0 = time.time()
    rids = [engine.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    while engine.has_work():
        engine.step()
    wall = time.time() - t0

    outs = [engine.output(r) for r in rids]
    lat = [o.latency for o in outs]
    ttft = [o.ttft for o in outs]
    total_tokens = sum(len(o.tokens) for o in outs)
    stats = engine.prefix_cache_stats
    return LoadReport(
        arch=engine.model.cfg.name,
        family=engine.model.cfg.family,
        n_requests=n_requests,
        concurrency=n_requests,
        prompt_len=prompt_len,
        max_new_tokens=max_new_tokens,
        wall_s=round(wall, 3),
        requests_per_s=round(n_requests / wall, 2),
        decode_tok_s=round(total_tokens / wall, 1),
        latency_p50_ms=round(percentile(lat, 50) * 1e3, 1),
        latency_p99_ms=round(percentile(lat, 99) * 1e3, 1),
        ttft_p50_ms=round(percentile(ttft, 50) * 1e3, 1),
        ttft_p99_ms=round(percentile(ttft, 99) * 1e3, 1),
        engine_steps=engine.steps,
        prefix_hit_rate=round(stats.hit_rate, 3),
    )
