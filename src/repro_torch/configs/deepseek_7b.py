"""deepseek-7b [dense]: 30L, d_model=4096, 32H (kv=32, MHA), d_ff=11008,
vocab=102400 — llama-arch [arXiv:2401.02954].  Same dims as
``repro.configs.deepseek_7b``.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    mlp="swiglu",
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=256, fsdp=False, dtype=torch.float32,
)
