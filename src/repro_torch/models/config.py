"""Model configuration dataclass (port of :mod:`repro.models.config`).

It holds the fields the ported families read.  The reference's
``modality`` and ``norm`` are labels its models never read (each family
builds its own norm: LayerNorm in encdec and rwkv6, RMSNorm elsewhere), so
the port carries neither.  ``fsdp`` is the reference's: it maps the
``embed`` axis to ``data`` in the sharding rules
(:mod:`repro_torch.distributed.sharding`), which the ``spmd`` mode trains
as ZeRO-3 (:mod:`repro_torch.distributed.zero`).  The reference's
``scan_layers`` has no counterpart: the port runs its layers in a Python
loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp: str = "swiglu"              # swiglu | gelu | geglu | relu2
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # the fused dispatch + expert-GEMM kernels; the port has no other MoE
    # path, so moe_mlp refuses False (the reference's unfused A/B baseline)
    fused_moe: bool = True

    # hybrid / recurrent (RecurrentGemma)
    block_pattern: Tuple[str, ...] = ()   # cycle of "R" (recurrent) / "A" (attention)
    window: Optional[int] = None          # local attention window (None: full causal)
    lru_width: Optional[int] = None
    conv_width: int = 4

    # rwkv
    rwkv_head_dim: int = 64
    decay_lora: int = 64

    # enc-dec (Whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    n_frames: int = 1500              # encoder positions (stubbed conv frontend)

    # vlm (Qwen2-VL)
    mrope_sections: Tuple[int, ...] = ()
    n_vision_patches: int = 0         # stubbed patch-embedding prefix length

    # sharding: ZeRO-3 sharding of the embed axis over "data"
    fsdp: bool = False

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

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (as the reference's ``param_count``
        counts it: norms, biases and whisper's position table are not
        counted).  ``active_only``: a MoE layer counts the
        ``experts_per_token`` experts a token runs plus the whole router (the
        roofline's model FLOPs, 6·N·tokens with active N)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim()
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "moe":
            e = self.experts_per_token if active_only else self.n_experts
            n = self.n_layers * (attn + 3 * d * ff * e + d * self.n_experts)  # + router
        elif self.family == "rglru":
            lw = self.lru_width or d
            rec = 2 * d * lw + lw * d + self.conv_width * lw + 3 * lw  # in/out + conv + gates
            n_att = sum(1 for i in range(self.n_layers)
                        if self.block_pattern[i % len(self.block_pattern)] == "A")
            n = n_att * (attn + 3 * d * ff) + (self.n_layers - n_att) * (rec + 3 * d * ff)
        elif self.family == "rwkv6":
            heads = d // self.rwkv_head_dim
            tm = 6 * d * d + 2 * self.decay_lora * d + heads * self.rwkv_head_dim
            n = self.n_layers * (tm + 2 * d * ff)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + 2 * d * ff)
            dec = self.n_dec_layers * (2 * attn + 2 * d * ff)
            n = enc + dec
        else:  # dense / vlm
            mlp_p = 3 * d * ff if self.mlp in ("swiglu", "geglu") else 2 * d * ff
            n = self.n_layers * (attn + mlp_p)
        n += V * d
        if not self.tie_embeddings and self.family != "encdec":
            n += V * d
        return int(n)
