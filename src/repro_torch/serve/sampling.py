"""Per-request sampling (port of :mod:`repro.serve.sampling`): greedy by
default, temperature / top-k opt-in.

Every request stream owns a ``torch.Generator`` seeded from
``(SamplingParams.seed, request_id)``, so a request draws the same chain
however it is batched.  The numbers differ from ``jax.random``'s: the port
holds its sampled streams to reproducibility, not to the JAX package's tokens.
Greedy rows (temperature 0) are an exact argmax.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0    # 0 => greedy argmax
    top_k: int = 0              # 0 => no restriction
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


GREEDY = SamplingParams()


def request_generator(params: SamplingParams, request_id: int,
                      device: torch.device) -> torch.Generator:
    """The generator of one request's sampling stream."""
    seed = np.random.SeedSequence([params.seed, request_id]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


def make_sample_fn(k_cap: int = 64) -> Callable:
    """Returns ``sample(logits, generators, temperature, top_k) -> tokens``.

    logits (B, V); one generator per row; temperature (B,) f32; top_k (B,)
    int (0 = unrestricted, clipped to ``min(k_cap, V)``).  Rows with
    temperature 0 take the argmax and never draw from their generator.
    """

    def sample(logits: torch.Tensor, generators: Sequence[torch.Generator],
               temperature: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
        B, V = logits.shape
        lf = logits.float()
        out = torch.argmax(lf, dim=-1).to(torch.int32)
        cap = min(k_cap, V)
        topv = torch.topk(lf, cap, dim=-1).values                     # (B, cap)
        for i in range(B):
            t = float(temperature[i])
            if t <= 0.0:
                continue
            row = lf[i]
            k = int(top_k[i])
            if k > 0:
                row = row.masked_fill(row < topv[i, min(k, cap) - 1], float("-inf"))
            probs = torch.softmax(row / max(t, 1e-6), dim=-1)
            out[i] = torch.multinomial(probs, 1, generator=generators[i])[0].to(torch.int32)
        return out

    return sample
