"""dbrx-132b [moe]: 40L, d_model=6144, 48H (GQA kv=8), d_ff=10752,
vocab=100352, MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base].
Same dims as ``repro.configs.dbrx_132b``.

The reference's config says ``norm="layernorm"``, but its ``models/moe.py``
never reads the field and normalizes with ``rms_norm`` throughout; the port
does the same and carries no ``norm`` field.  ``fsdp=True`` is the
reference's sharding option: ZeRO-3 over ``data`` in the ``spmd`` mode.
At full width (264 GB of bf16 weights) the model needs the expert- and
tensor-parallel path over ``model`` (``models/moe.py``'s group-local EP,
``train.steps.make_spmd_train_step(plan=)``) across several cards; one
card trains it cut to 1 of 40 layers over two ranks (``chip_smoke.py``
phase 38), and ``SMOKE`` runs whole.
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
    fsdp=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, n_experts=4, experts_per_token=2,
    fsdp=False, dtype=torch.float32,
)
