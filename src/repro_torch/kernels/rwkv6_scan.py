"""Launch wrapper of the CUDA WKV-6 scan (``csrc/rwkv6_scan.cu``).

Replaces ``repro/kernels/rwkv6_scan.py::rwkv6_scan``.  The wrapper checks
its inputs, allocates the outputs and launches on the current stream; it
never falls back.  Callers go through :func:`repro_torch.kernels.ops.rwkv6_scan`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (16, 64)   # the smoke config's and rwkv6-7b's


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,  # (B, S, H, D)
    u: torch.Tensor,                                                    # (H, D) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    what = "rwkv6_scan"
    B, S, H, D = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.dtype != r.dtype:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} must match r "
                             f"{tuple(r.shape)} {r.dtype}")
    if r.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {r.dtype} not in {list(DTYPES)}")
    if tuple(u.shape) != (H, D) or u.dtype != torch.float32:
        raise ValueError(f"{what}: u must be ({H}, {D}) float32")
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"{what}: head dim {D} not implemented (have {HEAD_DIMS})")
    out = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    _build.call(
        "repro_rwkv6_scan", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), out.data_ptr(), state.data_ptr(), B, S, H, D, DTYPES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    return out, state
