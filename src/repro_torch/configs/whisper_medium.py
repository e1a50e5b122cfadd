"""whisper-medium [audio]: enc-dec, 24 + 24 layers, d_model=1024, 16H (kv=16)
of 64, d_ff=4096, vocab=51865 [arXiv:2212.04356].  Same dims as
``repro.configs.whisper_medium``.  The conv audio frontend is a stub:
callers pass (B, 1500, 1024) frame embeddings.  The reference's
``modality="audio"`` and ``norm="layernorm"`` are labels no code reads;
``models/encdec.py`` builds LayerNorm itself, so the port carries neither.

vocab is padded 51865 -> 51872 (a multiple of 32), as in the reference;
labels stay < 51865.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51872,            # 51865 padded to /32
    n_frames=1500,
    mlp="gelu",
    qkv_bias=True,
    tie_embeddings=True,    # whisper ties decoder embedding and output head
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=160, n_frames=12, dtype=torch.float32,
)
