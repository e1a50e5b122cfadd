"""Model configuration dataclass (port of :mod:`repro.models.config`).

It holds the fields the ported families read; fields of families not yet
ported arrive with them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"            # dense | moe | rglru | rwkv6 | encdec | vlm

    # transformer dims
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None   # default: d_model // n_heads
    rope_theta: float = 10000.0
    mlp: str = "swiglu"
    tie_embeddings: bool = False

    # local attention window (None: full causal)
    window: Optional[int] = None

    # numerics
    dtype: torch.dtype = torch.float32
    # "native" keeps the decode KV cache in `dtype`; "int8" stores per-row
    # symmetric int8 + f32 scales, dequantized inside the decode kernel
    kv_cache_dtype: str = "native"
    logit_softcap: Optional[float] = None

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
