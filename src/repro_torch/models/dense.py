"""Dense llama-style decoder LM (GQA + RoPE + SwiGLU), port of
:mod:`repro.models.dense`.

Covers deepseek-7b, qwen1.5-4b (QKV bias), minitron-8b (squared-ReLU MLP)
and deepseek-coder-33b, and is the backbone of qwen2-vl
(:mod:`repro_torch.models.vlm`: ``inputs_embeds``, ``mrope_positions``,
``rope_offset``).

On a mesh whose ``model`` axis has two or more devices
(:func:`repro_torch.distributed.sharding.use_mesh`) the training forward is
tensor-parallel: each rank holds its ``model`` pieces of the weights and
runs its heads, FFN columns and vocabulary rows
(:class:`~repro_torch.distributed.tensor.TensorPlan`); its logits are its
vocabulary columns, which ``train.steps.cross_entropy`` reads as such.
Prefill and decode are tensor-parallel on the same mesh: the cache holds
the rank's pieces of the leaves that :func:`cache_logical_axes` names
(``Model.init_cache`` allocates them so), and the logits come back whole
(every rank's columns gathered), so every rank picks the same token.

Entry points:
  * ``init_params(cfg, seed=..., device=...)``        -> (params, logical_axes)
  * ``forward(params, cfg, tokens)``                   -> logits (train)
  * ``init_cache(cfg, batch, cache_len, device=...)``  -> zeroed KV cache
  * ``cache_logical_axes(cfg)``                        -> the cache's logical axes
  * ``prefill(params, cfg, tokens, cache_len)``        -> (last logits, cache)
  * ``decode_step(params, cfg, token, cache, pos)``    -> (logits, cache)
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding, tensor, zero
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamBuilder, build, stacked

PyTree = Any


def _init_block(s, cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    L.init_rmsnorm(s, "ln1", cfg.d_model)
    L.init_attention(s, "attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                     qkv_bias=cfg.qkv_bias)
    L.init_rmsnorm(s, "ln2", cfg.d_model)
    L.init_mlp(s, "mlp", cfg.mlp, cfg.d_model, cfg.d_ff)


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


def _layer(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked (L, ...) tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def head(params: PyTree, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The output head's table (the embedding's where tied), gathered whole
    under ZeRO-3 (:func:`repro_torch.distributed.zero.gather`)."""
    name = "embedding" if cfg.tie_embeddings else "lm_head"
    return zero.gather(params[name], name)


def embedding(params: PyTree) -> Dict[str, torch.Tensor]:
    """The token embedding's table, gathered whole under ZeRO-3."""
    return zero.gather(params["embedding"], "embedding")


def tensor_plan(cfg: ModelConfig):
    """``(TensorPlan or None, the context that holds the activations to
    their layout)`` of a training forward of any family on the mesh in
    scope.  Batch rows split over ``model`` too (the reference's
    DP-attention layout) run only the MoE layer's over-model path; the
    attention and the recurrent blocks over them are not ported."""
    tp = tensor.plan_for(cfg)
    if tp is None:
        return None, contextlib.nullcontext()
    if tp.axis.batch_over_model:
        raise NotImplementedError(
            f"the batch rule splits rows over 'model': the MoE layer runs that layout "
            f"(models/moe.py), the attention over it does not: {sharding.SHARDED_WEIGHTS}")
    return tp, sharding.logical_sizes(tensor.logical_sizes_of(cfg, tp))


def _final(params: PyTree, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    x = L.rms_norm(params["ln_f"], x)
    y = L.logits(head(params, cfg), x, tp)
    if cfg.logit_softcap:
        y = torch.tanh(y / cfg.logit_softcap) * cfg.logit_softcap
    return y


def _block_train(lp: Dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                 mrope_positions: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    h = L.rms_norm(lp["ln1"], x)
    h = L.attention_train(
        lp["attn"], h, positions=positions, causal=True, window=cfg.window,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections or None,
        mrope_positions=mrope_positions, precision=cfg.train_precision, tp=tp,
    )
    x = x + h
    h = L.rms_norm(lp["ln2"], x)
    return x + L.mlp_apply(lp["mlp"], h, cfg.mlp, tp)


def _scan_blocks(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                 body: Callable[[PyTree, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Run the stacked layers in order.  Each layer's leaves are views of the
    stacked (L, ...) leaves, so gradients land on the stacked leaf; with
    ``cfg.remat`` each layer keeps only its input and recomputes its forward
    in the backward (the reference's ``jax.checkpoint`` per layer)."""
    for i in range(cfg.n_layers):
        x = _run_layer(cfg, body, _layer(params["blocks"], i), x)
    return x


def _run_layer(cfg: ModelConfig, body: Callable[[PyTree, torch.Tensor], Any],
               lp: PyTree, x: torch.Tensor) -> Any:
    """One layer of a training forward: under ``cfg.remat`` only its input is
    kept and its forward recomputed in the backward (``jax.checkpoint``);
    without autograd (the encoder of a serving prefill) it just runs.  Under
    ZeRO-3 the layer's ``data``-sharded weights (``lp`` is a layer of
    ``params["blocks"]``) are gathered inside the recomputed body, so the
    backward gathers them again and no layer's whole weights outlive it.
    A tensor-parallel body's collectives (its copy-in and reduce-out) sit
    inside it too, so the recompute repeats them."""
    def run(shards, h):
        return body(zero.gather(shards, "blocks", stacked=True), h)

    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(run, lp, x, use_reentrant=False)
    return run(lp, x)


def _inputs(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            inputs_embeds: Optional[torch.Tensor], tp=None) -> torch.Tensor:
    if inputs_embeds is not None:
        return inputs_embeds.to(cfg.dtype)
    return L.embed(embedding(params), tokens, cfg.dtype, tp)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            inputs_embeds: Optional[torch.Tensor] = None,
            mrope_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training forward. tokens: (B, S) int -> logits (B, S, V);
    ``inputs_embeds`` (B, S, d) replaces the token embedding (the VLM's
    [patches | text] sequence).  Tensor-parallel on a mesh with a ``model``
    axis: then the logits are this rank's vocabulary columns where the axis
    divides the vocabulary."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        x = _inputs(params, cfg, tokens, inputs_embeds, tp)
        positions = torch.arange(x.shape[1], device=x.device)
        x = _scan_blocks(params, x, cfg,
                         lambda lp, h: _block_train(lp, h, cfg, positions, mrope_positions, tp))
        return _final(params, x, cfg, tp)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim())
    if cfg.kv_cache_dtype == "int8":
        # per-row symmetric int8 + f32 scale column: ~4x fewer KV-pool bytes
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
        }
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """The cache leaves' logical axes (``repro/models/dense.py:153``)."""
    ax = ("layers", "batch", "kv_seq", "act_kv_heads", None)
    if cfg.kv_cache_dtype == "int8":
        return {"k": ax, "k_scale": ax, "v": ax, "v_scale": ax}
    return {"k": ax, "v": ax}


def _mlp(lp: Dict, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    return L.mlp_apply(lp["mlp"], x, cfg.mlp, tp)


# (layer params, normed activations, cfg, tensor plan) -> the block's FFN output
FFN = Callable[[Dict, torch.Tensor, ModelConfig, Any], torch.Tensor]


@torch.no_grad()
def prefill_with(ffn: FFN, params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                 cache_len: int, *, inputs_embeds: Optional[torch.Tensor] = None,
                 mrope_positions: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill of the attention skeleton with ``ffn`` as each block's MLP;
    tensor-parallel on a mesh with a ``model`` axis (the module doc)."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        x = _inputs(params, cfg, tokens, inputs_embeds, tp)
        positions = torch.arange(x.shape[1], device=x.device)
        sections = (cfg.mrope_sections or None) if mrope_positions is not None else None
        kvs = []
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            hn = L.rms_norm(lp["ln1"], x)
            attn_out, kv = L.attention_prefill(
                lp["attn"], hn, positions=positions, cache_len=cache_len,
                causal=True, window=cfg.window, rope_theta=cfg.rope_theta,
                mrope_sections=sections, mrope_positions=mrope_positions,
                kv_cache_dtype=cfg.kv_cache_dtype, tp=tp,
            )
            x = x + attn_out
            x = x + ffn(lp, L.rms_norm(lp["ln2"], x), cfg, tp)
            kvs.append(kv)
        cache = {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}
        return tensor.whole_logits(_final(params, x[:, -1:], cfg, tp), tp), cache


@torch.no_grad()
def decode_step_with(ffn: FFN, params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                     rope_offset: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of the attention skeleton with ``ffn`` as each block's
    MLP; ``cache`` is updated in place and returned.  RoPE rotates at ``pos
    + rope_offset`` (the VLM's M-RoPE text position), the K/V row is written
    at ``pos``.  Tensor-parallel on a mesh with a ``model`` axis."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        x = L.embed(params["embedding"], token, cfg.dtype, tp)
        rope_pos = pos if rope_offset is None else pos + rope_offset
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            hn = L.rms_norm(lp["ln1"], x)
            attn_out, _ = L.attention_decode(
                lp["attn"], hn, _layer(cache, i), pos=rope_pos, window=cfg.window,
                rope_theta=cfg.rope_theta, slot=pos, tp=tp,
            )
            x = x + attn_out
            x = x + ffn(lp, L.rms_norm(lp["ln2"], x), cfg, tp)
        return tensor.whole_logits(_final(params, x, cfg, tp), tp), cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int, *,
            inputs_embeds: Optional[torch.Tensor] = None,
            mrope_positions: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt; return last-position logits (B, 1, V) + KV cache."""
    return prefill_with(_mlp, params, cfg, tokens, cache_len, inputs_embeds=inputs_embeds,
                        mrope_positions=mrope_positions)


def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                rope_offset: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token (B, 1), pos (B,) -> logits (B, 1, V).  ``cache`` is updated in
    place (the JAX package donates it) and returned."""
    return decode_step_with(_mlp, params, cfg, token, cache, pos, rope_offset)


def decode_writes(cfg: ModelConfig, cache: Dict[str, torch.Tensor], pos: Sequence[int],
                  rows: Sequence[int]) -> List[Tuple[torch.Tensor, Tuple[Any, ...]]]:
    """(leaf, index) pairs that cover everything ``decode_step`` writes for
    the batch ``rows`` at host positions ``pos``: the row at ``pos`` of every
    KV leaf (``layers.attention_decode`` writes at ``slot=pos``)."""
    dev = cache["k"].device
    at = (slice(None), torch.tensor(list(rows), dtype=torch.long, device=dev),
          torch.tensor([int(pos[r]) for r in rows], dtype=torch.long, device=dev))
    return [(leaf, at) for leaf in cache.values()]
