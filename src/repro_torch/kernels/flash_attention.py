"""Launch wrapper of the CUDA flash attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``.  The
wrapper checks its inputs, allocates the output and launches on the current
stream; it never falls back.  Callers go through
:func:`repro_torch.kernels.ops.flash_attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)   # the smoke config's and deepseek-7b's


def check_attention_inputs(q: torch.Tensor, tensors, what: str) -> None:
    """Device, dtype and contiguity checks shared by the attention wrappers."""
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"{what}: q dtype {q.dtype} not in {list(DTYPES)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: head dim {q.shape[-1]} not implemented (have {HEAD_DIMS})")


def flash_attention_fwd(
    q: torch.Tensor,        # (B, Sq, H, D)
    k: torch.Tensor,        # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    check_attention_inputs(q, (("q", q), ("k", k), ("v", v)), "flash_attention")
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} not a multiple of Hkv={Hkv}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if window is not None and window <= 0:
        raise ValueError("flash_attention: window must be positive")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.call(
        "repro_flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Skv, H, Hkv, D, int(causal), int(window or 0),
        DTYPES[q.dtype], stream,
    )
    return out
