"""Mixture-of-Experts decoder LM (dbrx-132b: 16e top-4; qwen3-moe-30b-a3b:
128e top-8), port of :mod:`repro.models.moe`: the dense attention skeleton
with a top-k MoE FFN in every block.

Token dispatch uses the sort-by-expert + capacity layout of the reference,
through the fused expert-GEMM and combine kernels (their plain versions for
CPU tensors).  On a mesh whose ``model`` axis divides the experts the layer
takes the reference's group-local expert-parallel path
(``_moe_mlp_local``): each rank runs the kernels on its own experts' slots
and the partial outputs are summed over ``model``.  The reference's
unfused ``dense`` dispatch, its A/B baseline, is not ported.  Prefill and
decode take the same path on a mesh, inside the dense skeleton's
tensor-parallel serving.

Entry points: ``init_params``, ``forward`` (training: logits and the
router's load-balance loss summed over the layers, which ``train.steps``
adds to the loss at ``aux_weight``), ``init_cache``, ``prefill``,
``decode_step`` (serving).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tensor
from repro_torch.distributed.sharding import with_logical_constraint as wlc
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


def moe_mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig,
            tp: Optional[tensor.TensorPlan] = None,
            aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss), as the reference's ``auto`` picks:
    the group-local expert-parallel path where ``tp`` shards the experts
    over ``model`` (:func:`_moe_mlp_local`), else routing, then the expert
    GEMM and combine kernels over all experts; the (T·k, d) token copies
    and the g/u intermediates never exist as tensors.  Serving passes
    ``aux=False``: the expert-parallel path then skips the router loss and
    its ``data`` statistics (a zero stands in)."""
    if not cfg.fused_moe:
        raise NotImplementedError(
            "fused_moe=False selects the reference's unfused dispatch, its A/B "
            "baseline; the port runs the MoE layer through the fused kernels only")
    if tp is not None and tp.experts:
        return _moe_mlp_local(p, x, cfg, tp.axis, aux)
    B, S, d = x.shape
    T = B * S
    C = expert_capacity(T, cfg.n_experts, cfg.experts_per_token, cfg.capacity_factor)
    out, aux = kops.fused_moe_mlp(
        x.reshape(T, d), p["router"], p["wi_gate"], p["wi_up"], p["wo"],
        k=cfg.experts_per_token, capacity=C,
    )
    return wlc(out.reshape(B, S, d), "batch", "seq", "act_embed"), aux


def _router_aux(x: torch.Tensor, router: torch.Tensor, k: int,
               axis: tensor.ModelAxis) -> torch.Tensor:
    """The Switch load-balance loss ``E Σ_e f_e p_e`` of a token group
    ``x`` (T, d) from statistics averaged over the ``data`` group (the
    reference's pmean over the dp axes), the same value on every rank."""
    E = router.shape[1]
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    ids = torch.topk(probs, k, dim=-1).indices
    tok_frac = torch.nn.functional.one_hot(ids, E).float().sum(dim=1).mean(dim=0)
    stats = tensor.data_mean(torch.stack([tok_frac, probs.mean(dim=0)]), axis)
    return E * torch.sum(stats[0] * stats[1])


def _moe_mlp_local(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                   axis: tensor.ModelAxis, aux: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The group-local EP dispatch (``repro/models/moe.py:98-233``).

    Token groups are the ``data`` shards; the rank holds experts
    ``index·E/m ..`` of the ``model`` axis (``m`` ranks) and routes its
    group's tokens over all E with the per-group capacity, keeping the
    slots of its own experts (:func:`~repro_torch.kernels.ops.
    fused_moe_local`: the expert GEMM and combine kernels on them).  The
    partial outputs are summed over ``model`` (reduce-scattered along the
    batch in the over-model layout, whose group rows are first all-gathered
    over ``model``).  The router, sharded over ``model`` with the experts,
    is gathered whole; its gradient through the outputs is each rank's part,
    summed by the gather's reduce-scatter.  The aux loss is whole on every
    rank, so only the rank at ``model`` coordinate 0 sends its gradient."""
    B, S, d = x.shape
    if axis.batch_over_model:
        xg = tensor.gather_batch(x, axis)
    else:
        xg = tensor.copy_in(x, axis)
    T = xg.shape[0] * S
    E, k = cfg.n_experts, cfg.experts_per_token
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    router = tensor.gather_weight(p["router"], 1, axis)
    xf = xg.reshape(T, d)
    out = kops.fused_moe_local(xf, router, p["wi_gate"], p["wi_up"], p["wo"], k=k, capacity=C,
                               first_expert=axis.index * (E // axis.size))
    if aux:
        loss = _router_aux(xf, router, k, axis)
        if axis.index != 0:
            loss = loss.detach()
    else:
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
    out = out.reshape(xg.shape[0], S, d)
    out = tensor.scatter_batch(out, axis) if axis.batch_over_model else \
        tensor.reduce_out(out, axis)
    return wlc(out, "batch", "seq", "act_embed"), loss


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


def _block_train(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    h = L.rms_norm(lp["ln1"], x)
    h = L.attention_train(
        lp["attn"], h, positions=positions, causal=True, window=cfg.window,
        rope_theta=cfg.rope_theta, precision=cfg.train_precision, tp=tp,
    )
    x = x + h
    y, aux = moe_mlp(lp["moe"], L.rms_norm(lp["ln2"], x), cfg, tp)
    return x + y, aux


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens (B, S) -> (logits (B, S, V), Σ_layers aux
    (float32)); under ``cfg.remat`` each layer keeps only its input and
    recomputes its forward, routing included, in the backward.
    Tensor- and expert-parallel on a mesh with a ``model`` axis, as
    :func:`repro_torch.models.dense.forward`."""
    tp, sizes = dense.tensor_plan(cfg)
    with sizes:
        x = L.embed(dense.embedding(params), tokens, cfg.dtype, tp)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x, a = dense._run_layer(cfg, lambda lp, h: _block_train(lp, h, cfg, positions, tp),
                                    dense._layer(params["blocks"], i), x)
            aux = aux + a
        return dense._final(params, x, cfg, tp), aux


init_cache = dense.init_cache
cache_logical_axes = dense.cache_logical_axes


def _moe_ffn(lp: Dict, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    return moe_mlp(lp["moe"], x, cfg, tp, aux=False)[0]     # serving drops the aux loss


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


decode_writes = dense.decode_writes
