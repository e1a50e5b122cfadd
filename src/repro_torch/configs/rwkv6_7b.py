"""rwkv6-7b [ssm]: 32L, d_model=4096 (attention-free, 64 heads of 64),
d_ff=14336, vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892].
O(1)-state decode.  Same dims and ``fsdp`` flag as ``repro.configs.rwkv6_7b``
(see :mod:`repro_torch.distributed.sharding`).  The reference's ``norm="layernorm"``
is read by no code there: ``models/rwkv6.py`` calls ``layer_norm`` itself, as
the port's does, so the port carries no ``norm`` field.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    n_layers=32,
    d_model=4096,
    n_heads=64,             # = d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    decay_lora=64,
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192, vocab=256,
    rwkv_head_dim=16, decay_lora=8, fsdp=False, dtype=torch.float32,
)
