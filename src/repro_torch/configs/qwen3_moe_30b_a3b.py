"""qwen3-moe-30b-a3b [moe]: 48L, d_model=2048, 32H (GQA kv=4), per-expert
d_ff=768, vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].  Same
dims as ``repro.configs.qwen3_moe_30b_a3b``.

As in the reference: no QK-norm, and capacity-factor dispatch (1.25) where
the HF model routes without drops.  ``fsdp=True`` (the reference's) shards
the ``embed`` axis over ``data``: in the ``spmd`` mode at data 2 or more
that is ZeRO-3 (:mod:`repro_torch.distributed.zero`); its experts over
``model`` run the group-local expert-parallel layer (``models/moe.py``).
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,               # per-expert hidden
    vocab=151936,
    n_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
    mlp="swiglu",
    rope_theta=1000000.0,
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=256, n_experts=8, experts_per_token=2,
    fsdp=False, dtype=torch.float32,
)
