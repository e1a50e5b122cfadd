"""Public attention ops of the port (counterpart of ``repro.kernels.ops``).

Each op picks its path from where its tensors lie:

* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`;
* a CUDA tensor launches the hand-written CUDA kernel, or raises.  There is
  no fallback and no ``use_kernel`` switch on the card.

``LAUNCHES`` counts kernel launches per op (plain integers, CUDA path only),
so a run can show that its attention went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import flash_attention_fwd

LAUNCHES: Dict[str, int] = {
    "flash_attention": 0,
    "decode_attention": 0,
    "decode_attention_int8": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D) in q.dtype."""
    if not q.is_cuda:
        return R.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_fwd(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


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
