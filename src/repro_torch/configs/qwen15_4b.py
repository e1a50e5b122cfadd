"""qwen1.5-4b [dense]: 40L, d_model=2560, 20H (kv=20), d_ff=6912, vocab=151936 —
QKV bias [hf:Qwen/Qwen1.5-*].  Same dims as ``repro.configs.qwen15_4b``.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1000000.0,
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=256, fsdp=False, dtype=torch.float32,
)
