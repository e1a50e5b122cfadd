"""deepseek-coder-33b [dense]: 62L, d_model=7168, 56H (GQA kv=8, a group of
7), d_ff=19200, vocab=32256 — llama-arch [arXiv:2401.14196].  Same dims as
``repro.configs.deepseek_coder_33b``.  33.3 B params: ~62 GiB of bf16
weights, which one 80 GB card holds for serving.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    mlp="swiglu",
    rope_theta=100000.0,    # deepseek-coder long-context base
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=256, fsdp=False, dtype=torch.float32,
)
