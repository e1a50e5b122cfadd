"""Step-level continuous-batching scheduler (a copy of ``repro.serve.scheduler``:
pure bookkeeping, no framework).

Each engine step the scheduler hands out a :class:`StepSchedule` under a hard
``token_budget``:

  * every RUNNING (decoding) request gets exactly 1 token — decode is
    prioritized so in-flight requests keep streaming and eventually free
    their slot (no starvation via decode);
  * remaining budget goes to chunked prefill, FCFS: partially-prefilled
    requests continue, then WAITING requests are admitted into free slots —
    a new request starts prefilling *while* older requests keep decoding
    (continuous batching), and a long prompt is consumed in
    ``prefill_chunk``-token chunks instead of stalling the decode batch.

Invariants (property-tested in ``tests/test_torch_serve_engine.py``):

  * scheduled tokens per step never exceed ``token_budget``;
  * admission is strictly FCFS (a later request never enters a slot while an
    earlier one is still waiting);
  * a slot is owned by at most one request at a time;
  * every request finishes in bounded steps (no starvation).
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class RequestStatus(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"     # decoding, 1 token per step
    FINISHED = "finished"


@dataclasses.dataclass
class RequestMeta:
    """Scheduler-visible request state (model state lives in the adapters)."""
    request_id: int
    prompt_len: int
    max_new_tokens: int
    status: RequestStatus = RequestStatus.WAITING
    slot: Optional[int] = None
    prefill_pos: int = 0        # prompt tokens already in the cache
    generated: int = 0          # tokens sampled so far


@dataclasses.dataclass(frozen=True)
class PrefillWork:
    request_id: int
    slot: int
    start: int                  # prompt positions [start, end) this step
    end: int
    last: bool                  # True when end == prompt_len (sample 1st token)


@dataclasses.dataclass(frozen=True)
class StepSchedule:
    admitted: Tuple[int, ...]           # request ids entering a slot this step
    prefill: Tuple[PrefillWork, ...]
    decode: Tuple[int, ...]             # request ids decoding 1 token
    total_tokens: int


class Scheduler:
    def __init__(self, *, max_slots: int, token_budget: int, prefill_chunk: int):
        if token_budget < prefill_chunk:
            raise ValueError("token_budget must cover at least one prefill chunk")
        if max_slots < 1 or prefill_chunk < 1:
            raise ValueError("max_slots and prefill_chunk must be >= 1")
        self.max_slots = max_slots
        self.token_budget = token_budget
        self.prefill_chunk = prefill_chunk
        self.waiting: Deque[int] = deque()
        self.requests: Dict[int, RequestMeta] = {}
        self._active_order: List[int] = []      # admission order of in-slot reqs
        self._free_slots: List[int] = list(range(max_slots))

    # -- request lifecycle ----------------------------------------------------

    def add(self, meta: RequestMeta) -> None:
        if meta.request_id in self.requests:
            raise ValueError(f"duplicate request id {meta.request_id}")
        self.requests[meta.request_id] = meta
        self.waiting.append(meta.request_id)

    def set_prefill_pos(self, request_id: int, pos: int) -> None:
        """Engine reports prefix-cache reuse: prompt positions [0, pos) are
        already resident, prefill resumes at ``pos``."""
        r = self.requests[request_id]
        if not 0 <= pos < r.prompt_len:
            raise ValueError(f"prefill pos {pos} out of range for {r.prompt_len}")
        r.prefill_pos = pos

    def finish(self, request_id: int) -> None:
        r = self.requests[request_id]
        r.status = RequestStatus.FINISHED
        if r.slot is not None:
            self._free_slots.append(r.slot)
            self._active_order.remove(request_id)
            r.slot = None

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self._active_order)

    @property
    def num_active(self) -> int:
        return len(self._active_order)

    # -- the step decision ----------------------------------------------------

    def admit(self) -> List[int]:
        """Move waiting requests into free slots, strictly FCFS."""
        admitted: List[int] = []
        while self.waiting and self._free_slots:
            rid = self.waiting.popleft()
            r = self.requests[rid]
            r.slot = self._free_slots.pop(0)
            r.status = RequestStatus.PREFILL
            self._active_order.append(rid)
            admitted.append(rid)
        return admitted

    def schedule(self) -> StepSchedule:
        """One step's worth of work.  Call AFTER :meth:`admit` (the engine
        admits first so prefix-cache hits can move the prefill cursor)."""
        budget = self.token_budget
        decode: List[int] = []
        prefill: List[PrefillWork] = []

        # decode first: 1 token per running request (slots bound this by
        # max_slots, and token_budget >= prefill_chunk >= 1 keeps them live)
        for rid in self._active_order:
            r = self.requests[rid]
            if r.status is RequestStatus.RUNNING and budget > 0:
                decode.append(rid)
                budget -= 1

        # then chunked prefill, oldest-admitted first
        for rid in self._active_order:
            r = self.requests[rid]
            if r.status is not RequestStatus.PREFILL or budget <= 0:
                continue
            n = min(self.prefill_chunk, r.prompt_len - r.prefill_pos, budget)
            if n <= 0:
                continue
            start, end = r.prefill_pos, r.prefill_pos + n
            prefill.append(PrefillWork(
                request_id=rid, slot=r.slot, start=start, end=end,
                last=(end == r.prompt_len),
            ))
            budget -= n

        total = len(decode) + sum(w.end - w.start for w in prefill)
        assert total <= self.token_budget
        return StepSchedule(
            admitted=(), prefill=tuple(prefill), decode=tuple(decode),
            total_tokens=total,
        )

    # -- engine feedback ------------------------------------------------------

    def note_prefilled(self, work: PrefillWork) -> None:
        r = self.requests[work.request_id]
        r.prefill_pos = work.end
        if work.last:
            # the last prompt position's logits produced the first token
            r.status = RequestStatus.RUNNING
            r.generated = 1

    def note_decoded(self, request_id: int) -> None:
        self.requests[request_id].generated += 1

    def is_done(self, request_id: int) -> bool:
        r = self.requests[request_id]
        return r.generated >= r.max_new_tokens
