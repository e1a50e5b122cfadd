"""`ServeSession` (port of :mod:`repro.api.serving`): prefill + KV-cache
decode behind one object, with the reference's family-aware control flow:
attention archs prefill with one batched ``Model.prefill``; recurrent archs
(rglru, rwkv6) step ``decode_step`` over the prompt from ``init_cache``, as
the reference's ``_prefill_recurrent`` does with its compiled scan.

    serve = ServeSession(model=model, params=params)          # device="cuda"
    out = serve.generate(prompt_tokens, max_new_tokens=16)
    print(out.tokens, out.decode_tok_s)

The decode loop updates the KV cache in place (the JAX package donates it).
Times are taken on the host clock after ``torch.cuda.synchronize()``.
``engine()`` and ``generate_many()`` come with the engine slice of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import Model
from repro_torch.serve.sampling import (
    GREEDY, SamplingParams, make_sample_fn, request_generator,
)
from repro_torch.train.steps import make_serve_step

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GenerateResult:
    tokens: torch.Tensor         # (B, 1 + max_new_tokens) generated ids
    prefill_time: float          # seconds spent in prefill
    decode_time: float           # seconds spent in the decode loop
    decode_tok_s: float          # aggregate decode throughput
    ms_per_step: float


class ServeSession:
    """Prefill/decode pair with a generate loop, on one device."""

    def __init__(self, *, model: Model, params: PyTree, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        table = params["embedding"]["table"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, session device is {self.device}")
        self.model = model
        self.params = params
        self._serve = make_serve_step(model)
        self._sample = make_sample_fn()

    @property
    def recurrent(self) -> bool:
        return self.model.cfg.family in ("rglru", "rwkv6")

    def _prefill_recurrent(self, prompt: torch.Tensor, cache_len: int):
        """The prompt one token at a time through ``decode_step``, the cache
        updated in place -> (last logits (B, V), cache)."""
        B, P = prompt.shape
        cache = self.model.init_cache(B, cache_len, device=self.device)
        for t in range(P):
            pos = torch.full((B,), t, dtype=torch.int32, device=self.device)
            logits, cache = self.model.decode_step(self.params, prompt[:, t:t + 1], cache, pos)
        return logits[:, -1], cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(
        self,
        prompt: torch.Tensor,              # (B, P) int token ids
        *,
        max_new_tokens: int = 16,
        cache_len: Optional[int] = None,
        sampling: SamplingParams = GREEDY,
    ) -> GenerateResult:
        prompt = torch.as_tensor(prompt).to(self.device)
        B, P = prompt.shape
        cache_len = cache_len or (P + max_new_tokens + 1)

        self._sync()
        t0 = time.perf_counter()
        if self.recurrent:
            logits, cache = self._prefill_recurrent(prompt, cache_len)
        else:
            logits, cache = self.model.prefill(self.params, prompt, cache_len)
            logits = logits[:, -1]

        greedy = sampling.temperature <= 0.0
        if greedy:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        else:
            # row i samples from request stream i, as the JAX ServeSession does
            gens = [request_generator(sampling, i, self.device) for i in range(B)]
            temp = torch.full((B,), sampling.temperature, dtype=torch.float32)
            topk = torch.full((B,), sampling.top_k, dtype=torch.int32)
            tok = self._sample(logits, gens, temp, topk)[:, None]
        self._sync()
        t1 = time.perf_counter()

        out = [tok]
        for t in range(max_new_tokens):
            pos = torch.full((B,), P + t, dtype=torch.int32, device=self.device)
            if greedy:
                tok, _, cache = self._serve(self.params, tok, cache, pos)
            else:
                logits, cache = self.model.decode_step(self.params, tok, cache, pos)
                tok = self._sample(logits[:, -1], gens, temp, topk)[:, None]
            out.append(tok)
        self._sync()
        dt = max(time.perf_counter() - t1, 1e-9)
        return GenerateResult(
            tokens=torch.cat(out, dim=1),
            prefill_time=t1 - t0,
            decode_time=dt,
            decode_tok_s=max_new_tokens * B / dt,
            ms_per_step=dt / max(1, max_new_tokens) * 1e3,
        )
