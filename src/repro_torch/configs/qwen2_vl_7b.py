"""qwen2-vl-7b [vlm]: 28L, d_model=3584, 28H (GQA kv=4, a group of 7),
d_ff=18944, vocab=152064 — M-RoPE [arXiv:2409.12191].  Same dims as
``repro.configs.qwen2_vl_7b``.  The vision patch frontend is a stub: callers
pass (B, n_patches, 3584) patch embeddings.  The reference's
``modality="vision"`` is a label no code reads; the port carries none.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),   # freq pairs: temporal / height / width (sum=64=D/2)
    n_vision_patches=1024,         # stub patch-grid prefix (32x32)
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=256, mrope_sections=(4, 2, 2), n_vision_patches=4,
    fsdp=False, dtype=torch.float32,
)
