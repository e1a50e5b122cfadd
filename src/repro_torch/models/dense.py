"""Dense llama-style decoder LM (GQA + RoPE + SwiGLU), port of
:mod:`repro.models.dense`.

Entry points:
  * ``init_params(cfg, seed=..., device=...)``        -> (params, logical_axes)
  * ``forward(params, cfg, tokens)``                   -> logits (train)
  * ``init_cache(cfg, batch, cache_len, device=...)``  -> zeroed KV cache
  * ``prefill(params, cfg, tokens, cache_len)``        -> (last logits, cache)
  * ``decode_step(params, cfg, token, cache, pos)``    -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamBuilder, build, stacked

PyTree = Any


def _init_block(s, cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    L.init_rmsnorm(s, "ln1", cfg.d_model)
    L.init_attention(s, "attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd)
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


def _final(params: PyTree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(params["ln_f"], x)
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    y = L.logits(head, x)
    if cfg.logit_softcap:
        y = torch.tanh(y / cfg.logit_softcap) * cfg.logit_softcap
    return y


def _block_train(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(lp["ln1"], x)
    h = L.attention_train(
        lp["attn"], h, positions=positions, causal=True, window=cfg.window,
        rope_theta=cfg.rope_theta, precision=cfg.train_precision,
    )
    x = x + h
    h = L.rms_norm(lp["ln2"], x)
    return x + L.mlp_apply(lp["mlp"], h, cfg.mlp)


def _scan_blocks(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                 body: Callable[[PyTree, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Run the stacked layers in order.  Each layer's leaves are views of the
    stacked (L, ...) leaves, so gradients land on the stacked leaf; with
    ``cfg.remat`` each layer keeps only its input and recomputes its forward
    in the backward (the reference's ``jax.checkpoint`` per layer)."""
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        if cfg.remat:
            x = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x = body(lp, x)
    return x


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Training forward. tokens: (B, S) int -> logits (B, S, V)."""
    x = L.embed(params["embedding"], tokens, cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _scan_blocks(params, x, cfg, lambda lp, h: _block_train(lp, h, cfg, positions))
    return _final(params, x, cfg)


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


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt; return last-position logits (B, 1, V) + KV cache."""
    x = L.embed(params["embedding"], tokens, cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    kvs = []
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        hn = L.rms_norm(lp["ln1"], x)
        attn_out, kv = L.attention_prefill(
            lp["attn"], hn, positions=positions, cache_len=cache_len,
            causal=True, window=cfg.window, rope_theta=cfg.rope_theta,
            kv_cache_dtype=cfg.kv_cache_dtype,
        )
        x = x + attn_out
        x = x + L.mlp_apply(lp["mlp"], L.rms_norm(lp["ln2"], x), cfg.mlp)
        kvs.append(kv)
    cache = {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}
    return _final(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token (B, 1), pos (B,) -> logits (B, 1, V).  ``cache`` is updated in
    place (the JAX package donates it) and returned."""
    x = L.embed(params["embedding"], token, cfg.dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        hn = L.rms_norm(lp["ln1"], x)
        attn_out, _ = L.attention_decode(
            lp["attn"], hn, _layer(cache, i), pos=pos, window=cfg.window,
            rope_theta=cfg.rope_theta, slot=pos,
        )
        x = x + attn_out
        x = x + L.mlp_apply(lp["mlp"], L.rms_norm(lp["ln2"], x), cfg.mlp)
    return _final(params, x, cfg), cache
