"""minitron-8b [dense]: 32L, d_model=4096, 32H (GQA kv=8), d_ff=16384,
vocab=256000 — pruned nemotron, squared-ReLU MLP [arXiv:2407.14679].  Same
dims as ``repro.configs.minitron_8b``.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    mlp="relu2",            # nemotron squared-ReLU
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=256, fsdp=False, dtype=torch.float32,
)
