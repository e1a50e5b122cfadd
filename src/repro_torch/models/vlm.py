"""Qwen2-VL backbone (arXiv:2409.12191), port of :mod:`repro.models.vlm`: the
dense decoder with M-RoPE.

The vision patch frontend is a stub, as in the reference: callers pass patch
embeddings (B, n_patches, d_model), placed before the text tokens'
embeddings.  M-RoPE splits head_dim/2 frequency pairs into (temporal,
height, width) sections, (16, 24, 24) at head dim 128.  Position ids: the
vision patches advance height and width over the (stub) patch grid at
temporal position 0; text tokens advance all three streams together, from
the grid's side.

Past the multimodal prefix all three streams move together, so a text
decode step is plain RoPE at position ``pos + mrope_offset``; ``prefill``
writes that offset into the cache (``mrope_offset``, (B,) int32) and
``decode_step`` reads it.

On a mesh with a ``model`` axis the training forward is the dense
decoder's tensor-parallel one; the text tokens go through the
vocabulary-parallel embedding before the patch embeddings (replicated over
``model``) are placed in front of them.  Prefill and decode are the dense
decoder's tensor-parallel serving, the text rows embedded the same way;
``mrope_offset`` is whole on every rank of a ``model`` group.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

PyTree = Any


def init_params(cfg: ModelConfig, **kw) -> Tuple[PyTree, PyTree]:
    return dense.init_params(cfg, **kw)


def mrope_positions(cfg: ModelConfig, batch: int, seq: int, grid: Optional[int] = None,
                    n_vis: Optional[int] = None, device=None) -> torch.Tensor:
    """(3, B, S) int32 position ids: the vision prefix (t = 0; h, w over the
    grid), then text."""
    n_vis = min(cfg.n_vision_patches, seq) if n_vis is None else n_vis
    grid = grid or max(1, int(n_vis ** 0.5))
    i = torch.arange(seq, device=device)
    is_vis = i < n_vis
    zero = torch.zeros_like(i)
    # text positions continue from the largest vision position
    t_pos = torch.where(is_vis, zero, i - n_vis + max(grid, 1))
    h = torch.where(is_vis, i // grid, t_pos)
    w = torch.where(is_vis, i % grid, t_pos)
    pos3 = torch.stack([t_pos, h, w]).to(torch.int32)            # (3, S)
    return pos3[:, None].expand(3, batch, seq)


def _sequence(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
              patch_embeds: Optional[torch.Tensor], tp=None
              ) -> Tuple[torch.Tensor, Optional[int]]:
    """[patches | text] embeddings, and the patch count (None without
    patches); under ``tp`` the text rows from the vocabulary shards."""
    x = L.embed(dense.embedding(params), tokens, cfg.dtype, tp)
    if patch_embeds is None:
        return x, None
    return torch.cat([patch_embeds.to(cfg.dtype), x], dim=1), patch_embeds.shape[1]


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S_text), patch_embeds (B, n_patches, d) -> logits for every
    position of [patches | text] (under a ``model`` axis, this rank's
    vocabulary columns)."""
    tp, sizes = dense.tensor_plan(cfg)
    with sizes:
        x, n_vis = _sequence(params, cfg, tokens, patch_embeds, tp)
    mpos = mrope_positions(cfg, x.shape[0], x.shape[1], n_vis=n_vis, device=x.device)
    return dense.forward(params, cfg, tokens, inputs_embeds=x, mrope_positions=mpos)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    cache = dense.init_cache(cfg, batch, cache_len, dtype=dtype, device=device)
    # the rope position of the text token at sequence index i is i + mrope_offset
    cache["mrope_offset"] = torch.zeros((batch,), dtype=torch.int32, device=cache["k"].device)
    return cache


def cache_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """The dense cache's axes and ``mrope_offset`` over ``batch``
    (``repro/models/vlm.py:74``)."""
    axes = dense.cache_logical_axes(cfg)
    axes["mrope_offset"] = ("batch",)
    return axes


def _kv(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The KV leaves (2 native or 4 int8), without ``mrope_offset``."""
    return {k: v for k, v in cache.items() if k != "mrope_offset"}


def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RoPE at ``pos + mrope_offset``, the K/V row written at ``pos``, in place."""
    logits, _ = dense.decode_step(params, cfg, token, _kv(cache), pos,
                                  rope_offset=cache["mrope_offset"])
    return logits, cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int, *,
            patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multimodal prefill over [patches | text], the M-RoPE phases in the
    cache.  Without ``patch_embeds`` (``ServeSession.generate``'s text-only
    route, as the reference's) the first ``min(n_vision_patches, S)`` token
    positions take the vision position ids.  On a mesh with a ``model``
    axis, tensor-parallel (the module doc)."""
    tp, sizes = dense.tensor_plan(cfg)
    with sizes:
        x, n_vis = _sequence(params, cfg, tokens, patch_embeds, tp)
    B, S = x.shape[0], x.shape[1]
    if n_vis is None:
        n_vis = min(cfg.n_vision_patches, S)
    mpos = mrope_positions(cfg, B, S, n_vis=n_vis, device=x.device)
    logits, cache = dense.prefill(params, cfg, tokens, cache_len, inputs_embeds=x,
                                  mrope_positions=mpos)
    start = max(1, int(n_vis ** 0.5))
    cache["mrope_offset"] = torch.full((B,), start - n_vis, dtype=torch.int32, device=x.device)
    return logits, cache


def decode_writes(cfg: ModelConfig, cache: Dict[str, torch.Tensor], pos: Sequence[int],
                  rows: Sequence[int]) -> List[Tuple[torch.Tensor, Tuple[Any, ...]]]:
    """What ``decode_step`` writes: the dense KV rows at ``pos``;
    ``mrope_offset`` is only read."""
    return dense.decode_writes(cfg, _kv(cache), pos, rows)
