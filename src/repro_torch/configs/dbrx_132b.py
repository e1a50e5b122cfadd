"""dbrx-132b [moe]: 40L, d_model=6144, 48H (GQA kv=8), d_ff=10752,
vocab=100352, MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base].
Same dims as ``repro.configs.dbrx_132b``.

The reference's config says ``norm="layernorm"``, but its ``models/moe.py``
never reads the field and normalizes with ``rms_norm`` throughout; the port
does the same and carries no ``norm`` field.  The reference's ``fsdp=True``
is a sharding option (ROADMAP item 13).  At full width (264 GB of bf16
weights) the model needs the expert-sharded multi-card path of item 13;
only ``SMOKE`` runs on one card.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    experts_per_token=4,
    capacity_factor=1.25,
    mlp="swiglu",
    rope_theta=500000.0,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, n_experts=4, experts_per_token=2,
    dtype=torch.float32,
)
