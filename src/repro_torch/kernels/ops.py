"""Public kernel ops of the port (counterpart of ``repro.kernels.ops``).

Each op picks its path from where its tensors lie:

* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`;
* a CUDA tensor launches the hand-written CUDA kernel, or raises.  There is
  no fallback and no ``use_kernel`` switch on the card.

The training ops are ``torch.autograd.Function``s with the reference's
``custom_vjp`` semantics: the forward runs the kernel (or, on the CPU, its
plain version) and saves only its inputs — int8 K/V and their scales for the
int8-fused op — and the backward recomputes through the plain attention
math (``repro/kernels/ops.py:60-69, 142-153``).  That recompute is the
reference's backward, not a fallback: the JAX package has no backward
kernel either.

``LAUNCHES`` counts kernel launches per kernel (plain integers, CUDA path
only), so a run can show that it went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd
from repro_torch.kernels.quantize import quantize_rows

LAUNCHES: Dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_q8": 0,
    "quantize_int8": 0,
    "decode_attention": 0,
    "decode_attention_int8": 0,
}

# no kernel: an elementwise product the reference also leaves to the compiler
dequantize_int8 = R.dequantize_int8_ref


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# int8 row quantizer
# ---------------------------------------------------------------------------


def quantize_int8(
    x: torch.Tensor,                      # (R, N) float
    noise: Union[torch.Tensor, float],    # (R, N) in [0, 1), or one value for all
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``scale = max(absmax/127, 1e-12)``,
    ``q = clip(floor(x/scale + noise), -127, 127)``.  -> (q int8, scale f32 (R, 1))."""
    if not x.is_cuda:
        return R.quantize_int8_ref(x, noise)
    out = quantize_rows(x, noise)
    LAUNCHES["quantize_int8"] += 1
    return out


def _quantize_q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-half-up int8 over the last axis of any shape (the training
    quantizer: constant noise 0.5)."""
    q, s = quantize_int8(x.reshape(-1, x.shape[-1]).contiguous(), 0.5)
    return q.view(x.shape), s.view(x.shape[:-1] + (1,))


# ---------------------------------------------------------------------------
# flash attention (differentiable)
# ---------------------------------------------------------------------------


def _attention_vjp(q, k, v, g, causal, window):
    """Gradients of the plain attention at (q, k, v) against ``g``."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = R.flash_attention_ref(qd, kd, vd, causal=causal, window=window)
        return torch.autograd.grad(out, (qd, kd, vd), g)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if not q.is_cuda:
            return R.flash_attention_ref(q, k, v, causal=causal, window=window)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        LAUNCHES["flash_attention"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_attention_vjp(q, k, v, g, ctx.causal, ctx.window), None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D) in q.dtype."""
    return _FlashAttention.apply(q, k, v, causal, window)


class _FlashAttentionQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        kq, ks = _quantize_q8(k)
        vq, vs = _quantize_q8(v)
        ctx.save_for_backward(q, kq, ks, vq, vs)
        ctx.causal, ctx.window = causal, window
        ctx.k_dtype, ctx.v_dtype = k.dtype, v.dtype
        if not q.is_cuda:
            return R.flash_attention_ref(
                q, R.dequantize_int8_ref(kq, ks), R.dequantize_int8_ref(vq, vs),
                causal=causal, window=window)
        out = flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=causal, window=window)
        LAUNCHES["flash_attention_q8"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        # straight-through across the rounding: the base op's gradient at
        # the dequantized K/V, cast back to the primal dtypes
        q, kq, ks, vq, vs = ctx.saved_tensors
        dq, dk, dv = _attention_vjp(
            q, R.dequantize_int8_ref(kq, ks), R.dequantize_int8_ref(vq, vs), g,
            ctx.causal, ctx.window)
        return dq.to(q.dtype), dk.to(ctx.k_dtype), dv.to(ctx.v_dtype), None, None


def flash_attention_q8(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Int8-fused training attention: K/V are quantized per row (round half
    up), attention runs over the int8 K/V with f32 accumulation, and the
    backward residuals are the int8 K/V + scales instead of float K/V."""
    return _FlashAttentionQ8.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# decode attention (inference only — no backward)
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query row per (batch, head) against a contiguous cache; positions
    ``< valid_len[b]`` attend.  q (B, 1, H, D), k/v (B, Skv, Hkv, D)."""
    if not q.is_cuda:
        return R.decode_attention_ref(q, k, v, valid_len, window=window)
    out = DA.decode_attention(q, k, v, valid_len, window=window)
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_int8(
    q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
    v: torch.Tensor, v_scale: torch.Tensor, valid_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`decode_attention` over an int8 cache + per-row f32 scales,
    dequantized inside the kernel."""
    if not q.is_cuda:
        return R.decode_attention_int8_ref(
            q, k, k_scale, v, v_scale, valid_len, window=window)
    out = DA.decode_attention_int8(q, k, k_scale, v, v_scale, valid_len, window=window)
    LAUNCHES["decode_attention_int8"] += 1
    return out
