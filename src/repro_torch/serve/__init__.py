"""`repro_torch.serve` (port of :mod:`repro.serve`): the continuous-batching
serving engine.

    from repro_torch.serve import ServeEngine, EngineConfig, SamplingParams

    engine = ServeEngine(model=model, params=params, config=EngineConfig())
    rid = engine.submit(prompt_ids, max_new_tokens=16)
    while engine.has_work():
        for ev in engine.step():          # streams per-request, in order
            ...

Subsystem layout: :mod:`~repro_torch.serve.scheduler` (step-level admission /
chunked prefill under a token budget), :mod:`~repro_torch.serve.block_cache`
(ref-counted blocks + hash-chain prefix cache), :mod:`~repro_torch.serve.adapters`
(per-family cache layouts), :mod:`~repro_torch.serve.runner` (the decode and
extend steps), :mod:`~repro_torch.serve.sampling` (per-request generator
streams), :mod:`~repro_torch.serve.loadgen` (synthetic-user benchmark harness).
"""
from repro_torch.serve.adapters import (
    PagedKVAdapter, RecurrentStateAdapter, make_adapter,
)
from repro_torch.serve.block_cache import BlockAllocator, CacheStats, hash_chain
from repro_torch.serve.engine import (
    EngineConfig, GenOutput, ServeEngine, StreamEvent,
)
from repro_torch.serve.loadgen import LoadReport, run_load
from repro_torch.serve.runner import StepRunner
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.scheduler import (
    PrefillWork, RequestMeta, RequestStatus, Scheduler, StepSchedule,
)

__all__ = [
    "BlockAllocator",
    "CacheStats",
    "EngineConfig",
    "GenOutput",
    "GREEDY",
    "LoadReport",
    "PagedKVAdapter",
    "PrefillWork",
    "RecurrentStateAdapter",
    "RequestMeta",
    "RequestStatus",
    "SamplingParams",
    "ServeEngine",
    "Scheduler",
    "StepRunner",
    "StepSchedule",
    "StreamEvent",
    "hash_chain",
    "make_adapter",
    "run_load",
]
