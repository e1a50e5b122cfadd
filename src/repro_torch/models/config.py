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
    # training hot-loop precision:
    #   "f32"        — attention streams activations at the model dtype
    #   "bf16"       — attention operands cast to bf16 before the kernel
    #   "int8-fused" — K/V quantized per row to int8, dequantized inside the
    #                  flash kernel (f32 accumulation), and saved for the
    #                  backward as int8 + scales
    train_precision: str = "f32"
    remat: bool = True               # recompute each layer in the backward
    logit_softcap: Optional[float] = None

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count of the dense family (as the reference's
        ``param_count`` counts it)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim()
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        mlp_p = 3 * d * ff if self.mlp in ("swiglu", "geglu") else 2 * d * ff
        n = self.n_layers * (attn + mlp_p) + V * d
        if not self.tie_embeddings:
            n += V * d
        return int(n)
