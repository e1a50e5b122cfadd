"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

Each function is the mathematical definition, written for clarity not speed.
The CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold them
to the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel to them on
the card.  Masks and the 0-for-a-fully-masked-row rule follow
``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by repeating each kv head ``H/Hkv`` times."""
    hkv = k.shape[2]
    return k if hkv == n_heads else k.repeat_interleave(n_heads // hkv, dim=2)


def _masked_softmax_av(logits: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis where ``mask`` holds, rows with no live
    position give 0; then ``probs @ v``.  logits (B,H,Sq,Skv), v (B,Skv,H,D)."""
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def flash_attention_ref(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D)
    v: torch.Tensor,               # (B, Skv, Hkv, D)
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    return _masked_softmax_av(logits, mask[None, None], v).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,               # (B, 1, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D) cache
    v: torch.Tensor,               # (B, Skv, Hkv, D)
    valid_len: torch.Tensor,       # (B,) int — positions < valid_len attend
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, _, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = valid_len.to(device=q.device, dtype=torch.int64)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = k_pos < valid
    if window is not None:
        mask &= k_pos > (valid - 1 - window)
    return _masked_softmax_av(logits, mask[:, None, None, :], v).to(q.dtype)


def decode_attention_int8_ref(
    q: torch.Tensor,               # (B, 1, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D) int8 cache
    k_scale: torch.Tensor,         # (B, Skv, Hkv, 1) f32 per-row scales
    v: torch.Tensor,               # (B, Skv, Hkv, D) int8
    v_scale: torch.Tensor,         # (B, Skv, Hkv, 1) f32
    valid_len: torch.Tensor,       # (B,) int
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Dequantize the int8 cache, then dense decode (the fused kernel's target)."""
    kf = dequantize_int8_ref(k, k_scale, torch.float32)
    vf = dequantize_int8_ref(v, v_scale, torch.float32)
    return decode_attention_ref(q, kf, vf, valid_len, window=window)


def quantize_int8_ref(
    x: torch.Tensor,                                  # (..., N) float
    noise: Union[torch.Tensor, float, None] = None,   # same shape (or one value), in [0, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: scale = max(absmax/127, 1e-12).

    ``noise=None`` rounds half to even (``torch.round``, as ``jnp.round``;
    the serve cache's quantizer); otherwise ``floor(x/scale + noise)`` —
    stochastic rounding with U[0,1) noise, round half up at a constant 0.5
    (the training quantizer, ``repro/kernels/quantize.py::_quantize_rows``).
    Returns (q int8, scale f32 (..., 1)).
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if noise is None:
        # as the JAX oracle computes it op by op: a true division by 127
        scale = torch.clamp(absmax / 127.0, min=1e-12)
        q = torch.round(xf / scale)
    else:
        # as the JAX kernel computes it: XLA folds the constant divisor into a
        # multiply by its float32 reciprocal (1 ulp off the division on some
        # rows); the division by the scale stays a true division
        scale = torch.clamp(absmax * (1.0 / 127.0), min=1e-12)
        q = torch.floor(xf / scale + torch.as_tensor(noise, dtype=torch.float32,
                                                      device=x.device))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_int8_ref(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def flash_attention_q8_ref(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D) float
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention with K/V squeezed through per-row int8, round half up
    (constant noise 0.5): the int8-fused training attention."""
    kq, ks = quantize_int8_ref(k, 0.5)
    vq, vs = quantize_int8_ref(v, 0.5)
    return flash_attention_ref(q, dequantize_int8_ref(kq, ks), dequantize_int8_ref(vq, vs),
                               causal=causal, window=window)
