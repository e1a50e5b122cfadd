"""`ServeEngine` (port of :mod:`repro.serve.engine`): continuous-batching
serving with streaming outputs.

Requests enter a queue, a step-level scheduler admits them into the
in-flight decode batch (chunked prefill interleaves with decode instead of
stalling it), and a per-family cache adapter keeps their context resident:
paged ref-counted KV blocks for attention families, O(1)-state slots with
snapshot prefix caching for recurrent ones.

    engine = ServeEngine(model=model, params=params)          # device="cuda"
    rid = engine.submit([1, 2, 3], max_new_tokens=8)
    while engine.has_work():
        for ev in engine.step():
            print(ev.request_id, ev.token, ev.done)   # streams in token order

The control flow is the reference's.  The one change is the sampler's
randomness: each request draws from its own ``torch.Generator`` (seeded from
``(SamplingParams.seed, request id)``), in token order, where the reference
folds the token index into a per-request ``jax.random`` key.  The two agree
in what they promise (a request's chain does not depend on how it is batched)
as long as every generated token draws exactly once, in order: token 0 when
the prompt completes, token i at the i-th decode step the request takes part
in.  :class:`StepRunner` keeps that so: inactive slots never draw.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import Model
from repro_torch.serve.adapters import make_adapter, slot_slice
from repro_torch.serve.runner import StepRunner
from repro_torch.serve.sampling import GREEDY, SamplingParams, request_generator
from repro_torch.serve.scheduler import RequestMeta, Scheduler

PyTree = Any


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8          # concurrent decode batch size
    max_len: int = 64           # per-slot context rows (attention families)
    block_size: int = 8         # prefix-cache block granularity (tokens)
    num_blocks: int = 128       # pool pages / state snapshots
    prefill_chunk: int = 16     # prompt tokens per prefill step
    token_budget: int = 32      # scheduled tokens per engine step
    k_cap: int = 64             # top-k bound for the sampler
    eos_token: Optional[int] = None

    def __post_init__(self):
        if self.prefill_chunk % self.block_size:
            raise ValueError(
                "prefill_chunk must be a multiple of block_size so chunk "
                "boundaries align with prefix-cache blocks"
            )


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    request_id: int
    token: int
    index: int                  # 0-based position in the generated stream
    done: bool
    finish_reason: Optional[str] = None    # "length" | "stop"


@dataclasses.dataclass
class GenOutput:
    request_id: int
    prompt_len: int
    tokens: List[int]
    finish_reason: str = ""
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.submit_time


@dataclasses.dataclass
class _Record:
    prompt: tuple
    max_new_tokens: int
    sampling: SamplingParams
    generator: Optional[torch.Generator]     # None for greedy requests
    out: GenOutput


class ServeEngine:
    def __init__(self, *, model: Model, params: PyTree,
                 config: EngineConfig = EngineConfig(), device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        table = params["embedding"]["table"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, engine device is {self.device}")
        self.model = model
        self.params = params
        self.config = config
        self.adapter = make_adapter(
            model, n_slots=config.max_slots, max_len=config.max_len,
            num_blocks=config.num_blocks, block_size=config.block_size, device=self.device,
        )
        self.runner = StepRunner(model, k_cap=config.k_cap)
        self.scheduler = Scheduler(
            max_slots=config.max_slots, token_budget=config.token_budget,
            prefill_chunk=config.prefill_chunk,
        )
        self._records: Dict[int, _Record] = {}
        self._next_id = 0
        S = config.max_slots
        # per-slot decode-side state (host mirrors of the step's inputs)
        self._slot_tok = np.zeros((S,), np.int32)
        self._slot_pos = np.zeros((S,), np.int32)
        self._slot_temp = np.zeros((S,), np.float32)
        self._slot_topk = np.zeros((S,), np.int32)
        self.steps = 0
        self.tokens_decoded = 0

    # -- submission -----------------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 16,
               sampling: SamplingParams = GREEDY) -> int:
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not self.adapter.fits(len(prompt), max_new_tokens):
            raise ValueError(
                f"prompt_len={len(prompt)} + max_new_tokens={max_new_tokens} "
                f"exceeds max_len={self.config.max_len}"
            )
        rid = self._next_id
        self._next_id += 1
        gen = (request_generator(sampling, rid, self.device)
               if sampling.temperature > 0 else None)
        self._records[rid] = _Record(
            prompt=prompt, max_new_tokens=max_new_tokens, sampling=sampling,
            generator=gen,
            out=GenOutput(request_id=rid, prompt_len=len(prompt), tokens=[],
                          submit_time=time.time()),
        )
        self.scheduler.add(RequestMeta(
            request_id=rid, prompt_len=len(prompt),
            max_new_tokens=max_new_tokens,
        ))
        return rid

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def output(self, request_id: int) -> GenOutput:
        return self._records[request_id].out

    @property
    def prefix_cache_stats(self):
        return self.adapter.allocator.stats

    # -- the engine step ------------------------------------------------------

    def step(self) -> List[StreamEvent]:
        events: List[StreamEvent] = []

        for rid in self.scheduler.admit():
            rec = self._records[rid]
            meta = self.scheduler.requests[rid]
            cached = self.adapter.admit(meta.slot, rec.prompt)
            if cached:
                self.scheduler.set_prefill_pos(rid, cached)

        sched = self.scheduler.schedule()

        for w in sched.prefill:
            events.extend(self._run_prefill_chunk(w))

        if sched.decode:
            events.extend(self._run_decode(sched.decode))

        self.steps += 1
        return events

    def _run_prefill_chunk(self, w) -> List[StreamEvent]:
        rec = self._records[w.request_id]
        chunk = torch.tensor([rec.prompt[w.start:w.end]], dtype=torch.int32,
                             device=self.device)                     # (1, C)
        # the chunk steps through a view of the slot: it writes the slot in place
        sub = slot_slice(self.adapter.cache, w.slot)
        logits, _ = self.runner.extend(self.params, chunk, sub, w.start)
        self.adapter.snapshot(w.slot, rec.prompt, w.end)
        self.scheduler.note_prefilled(w)
        if not w.last:
            return []

        # prompt complete: publish prefix blocks, sample the first token
        self.adapter.publish(w.slot, rec.prompt)
        sp = rec.sampling
        tok = self.runner.sample1(
            logits, [rec.generator],
            torch.tensor([sp.temperature], dtype=torch.float32),
            torch.tensor([sp.top_k], dtype=torch.int32),
        )
        t = int(tok[0])
        rec.out.first_token_time = time.time()
        self._slot_tok[w.slot] = t
        self._slot_pos[w.slot] = len(rec.prompt)
        self._slot_temp[w.slot] = sp.temperature
        self._slot_topk[w.slot] = sp.top_k
        return [self._emit(w.request_id, t)]

    def _run_decode(self, decode_ids) -> List[StreamEvent]:
        S = self.config.max_slots
        active = np.zeros((S,), bool)
        generators: List[Optional[torch.Generator]] = [None] * S
        slot_of = {}
        for rid in decode_ids:
            slot = self.scheduler.requests[rid].slot
            active[slot] = True
            generators[slot] = self._records[rid].generator
            slot_of[rid] = slot
        tok_out, _ = self.runner.decode(
            self.params,
            torch.from_numpy(self._slot_tok)[:, None].to(self.device),
            self.adapter.cache,
            self._slot_pos,
            active,
            generators,
            self._slot_temp,
            self._slot_topk,
        )
        tok_np = tok_out.cpu().numpy()
        events = []
        for rid in decode_ids:
            slot = slot_of[rid]
            t = int(tok_np[slot])
            self.scheduler.note_decoded(rid)
            self._slot_tok[slot] = t
            self._slot_pos[slot] += 1
            self.tokens_decoded += 1
            events.append(self._emit(rid, t))
        return events

    def _emit(self, rid: int, token: int) -> StreamEvent:
        rec = self._records[rid]
        rec.out.tokens.append(token)
        idx = len(rec.out.tokens) - 1
        done_len = self.scheduler.is_done(rid)
        done_eos = (self.config.eos_token is not None
                    and token == self.config.eos_token)
        if done_len or done_eos:
            meta = self.scheduler.requests[rid]
            self.adapter.release(meta.slot)
            self.scheduler.finish(rid)
            rec.out.finish_reason = "length" if done_len else "stop"
            rec.out.finish_time = time.time()
            return StreamEvent(rid, token, idx, True, rec.out.finish_reason)
        return StreamEvent(rid, token, idx, False)

    # -- convenience ----------------------------------------------------------

    def run_to_completion(self) -> List[StreamEvent]:
        events: List[StreamEvent] = []
        while self.has_work():
            events.extend(self.step())
        return events

    def generate_batch(
        self, prompts: Sequence[Sequence[int]], *, max_new_tokens: int = 16,
        sampling: SamplingParams = GREEDY,
    ) -> List[GenOutput]:
        rids = [self.submit(p, max_new_tokens=max_new_tokens, sampling=sampling)
                for p in prompts]
        self.run_to_completion()
        return [self.output(r) for r in rids]
