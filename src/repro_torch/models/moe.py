"""Mixture-of-Experts decoder LM (dbrx-132b: 16e top-4; qwen3-moe-30b-a3b:
128e top-8), port of :mod:`repro.models.moe`: the dense attention skeleton
with a top-k MoE FFN in every block.

Token dispatch uses the sort-by-expert + capacity layout of the reference,
through the fused expert-GEMM and combine kernels (their plain versions for
CPU tensors).  The reference's unfused ``dense`` dispatch is its A/B
baseline, and its group-local expert-parallel path (``local``) needs a
``model`` mesh; neither is ported.

Entry points: ``init_params``, ``init_cache``, ``prefill``, ``decode_step``
(serving).  The training ``forward`` comes with MoE training.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamBuilder, build, scaled_init, stacked

PyTree = Any


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------


def init_moe_mlp(b, name: str, d_model: int, d_ff: int, n_experts: int):
    s = b.scope(name)
    s.param("router", (d_model, n_experts), ("embed", "experts"), init=scaled_init(0))
    s.param("wi_gate", (n_experts, d_model, d_ff),
            ("experts", "embed", "expert_mlp"), init=scaled_init(-2))
    s.param("wi_up", (n_experts, d_model, d_ff),
            ("experts", "embed", "expert_mlp"), init=scaled_init(-2))
    s.param("wo", (n_experts, d_ff, d_model),
            ("experts", "expert_mlp", "embed"), init=scaled_init(-2))


def expert_capacity(n_tokens: int, n_experts: int, k: int, capacity_factor: float) -> int:
    c = int(n_tokens * k * capacity_factor / n_experts)
    return max(8, ((c + 127) // 128) * 128)  # the reference's MXU alignment, kept


def moe_mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss): routing, then the expert GEMM and
    combine kernels; the (T·k, d) token copies and the g/u intermediates
    never exist as tensors."""
    if not cfg.fused_moe:
        raise NotImplementedError(
            "fused_moe=False selects the reference's unfused dispatch, its A/B "
            "baseline; the port runs the MoE layer through the fused kernels only")
    B, S, d = x.shape
    T = B * S
    C = expert_capacity(T, cfg.n_experts, cfg.experts_per_token, cfg.capacity_factor)
    out, aux = kops.fused_moe_mlp(
        x.reshape(T, d), p["router"], p["wi_gate"], p["wi_up"], p["wo"],
        k=cfg.experts_per_token, capacity=C,
    )
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Model = dense skeleton with MoE FFN
# ---------------------------------------------------------------------------


def _init_block(s, cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    L.init_rmsnorm(s, "ln1", cfg.d_model)
    L.init_attention(s, "attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd)
    L.init_rmsnorm(s, "ln2", cfg.d_model)
    init_moe_mlp(s, "moe", cfg.d_model, cfg.d_ff, cfg.n_experts)


def init_params(
    cfg: ModelConfig,
    *,
    seed: Optional[int] = None,
    abstract: bool = False,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = "cuda",
) -> Tuple[PyTree, PyTree]:
    """Random weights from a seeded generator on ``device`` (or meta tensors)."""
    dev = torch.device("meta") if abstract else resolve_device(device)

    def f(b: ParamBuilder):
        L.init_embedding(b, "embedding", cfg.vocab, cfg.d_model)
        _init_block(stacked(b, cfg.n_layers).scope("blocks"), cfg)
        L.init_rmsnorm(b, "ln_f", cfg.d_model)
        if not cfg.tie_embeddings:
            L.init_embedding(b, "lm_head", cfg.vocab, cfg.d_model)

    return build(f, seed=seed, abstract=abstract, dtype=dtype or cfg.dtype, device=dev)


init_cache = dense.init_cache


def _moe_ffn(lp: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return moe_mlp(lp["moe"], x, cfg)[0]          # serving drops the aux loss


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt; return last-position logits (B, 1, V) + KV cache."""
    return dense.prefill_with(_moe_ffn, params, cfg, tokens, cache_len)


def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token (B, 1), pos (B,) -> logits (B, 1, V); ``cache`` is updated in
    place and returned."""
    return dense.decode_step_with(_moe_ffn, params, cfg, token, cache, pos)
