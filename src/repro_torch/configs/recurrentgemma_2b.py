"""recurrentgemma-2b [hybrid]: 26L, d_model=2560, 10H (kv=1), d_ff=7680,
vocab=256000 — RG-LRU + local attention in a 1:2 pattern (R, R, A)
[arXiv:2402.19427].  Same dims as ``repro.configs.recurrentgemma_2b``.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="rglru",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,              # 3x multiplier, GeGLU
    vocab=256000,
    block_pattern=("R", "R", "A"),
    window=2048,            # local attention window
    lru_width=2560,
    conv_width=4,
    mlp="geglu",
    tie_embeddings=True,    # Gemma convention
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=192, vocab=256, window=8, lru_width=64, dtype=torch.float32,
)
