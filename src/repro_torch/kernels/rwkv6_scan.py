"""Launch wrappers of the CUDA WKV-6 scans (``csrc/rwkv6_scan.cu``): float
r/k/v, and int8 r/k/v with row scales.

Replace ``repro/kernels/rwkv6_scan.py::rwkv6_scan`` and ``::rwkv6_scan_int8``.
Each wrapper checks its inputs, allocates the outputs and launches on the
current stream; it never falls back.  Callers go through
:func:`repro_torch.kernels.ops.rwkv6_scan` and
:func:`repro_torch.kernels.ops.rwkv6_scan_q8`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (16, 64)   # the smoke config's and rwkv6-7b's


def _check(what: str, r: torch.Tensor, tensors, w: torch.Tensor, u: torch.Tensor) -> None:
    """Device, contiguity, shape and the float dtypes of w and u."""
    B, S, H, D = r.shape
    for name, t in tensors:
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if w.shape != r.shape:
        raise ValueError(f"{what}: w {tuple(w.shape)} must match r {tuple(r.shape)}")
    if w.dtype not in DTYPES:
        raise TypeError(f"{what}: w dtype {w.dtype} not in {list(DTYPES)}")
    if tuple(u.shape) != (H, D) or u.dtype != torch.float32:
        raise ValueError(f"{what}: u must be ({H}, {D}) float32")
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"{what}: head dim {D} not implemented (have {HEAD_DIMS})")


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,   # (B, S, H, D)
    w: torch.Tensor,                                     # (B, S, H, D) f32 or bf16
    u: torch.Tensor,                                     # (H, D) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, S, H, D) in r.dtype, final state (B, H, D, D) f32)."""
    what = "rwkv6_scan"
    _check(what, r, (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)), w, u)
    for name, t in (("k", k), ("v", v)):
        if t.shape != r.shape or t.dtype != r.dtype:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} must match r "
                             f"{tuple(r.shape)} {r.dtype}")
    if r.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {r.dtype} not in {list(DTYPES)}")
    B, S, H, D = r.shape
    out = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    _build.call(
        "repro_rwkv6_scan", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), out.data_ptr(), state.data_ptr(), B, S, H, D, DTYPES[r.dtype],
        DTYPES[w.dtype], torch.cuda.current_stream(r.device).cuda_stream,
    )
    return out, state


def rwkv6_scan_int8(
    r: torch.Tensor, r_scale: torch.Tensor,   # (B, S, H, D) int8, (B, S, H, 1) f32
    k: torch.Tensor, k_scale: torch.Tensor,
    v: torch.Tensor, v_scale: torch.Tensor,
    w: torch.Tensor,                          # (B, S, H, D) float decay
    u: torch.Tensor,                          # (H, D) f32
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over int8 r/k/v dequantized on chip.  -> (out (B, S, H, D) in
    ``out_dtype``, final state (B, H, D, D) f32)."""
    what = "rwkv6_scan_int8"
    _check(what, r, (("r", r), ("r_scale", r_scale), ("k", k), ("k_scale", k_scale),
                     ("v", v), ("v_scale", v_scale), ("w", w), ("u", u)), w, u)
    sshape = tuple(r.shape[:3]) + (1,)
    for name, t, s in (("r", r, r_scale), ("k", k, k_scale), ("v", v, v_scale)):
        if t.shape != r.shape or t.dtype != torch.int8:
            raise ValueError(f"{what}: {name} must be int8 shaped like r {tuple(r.shape)}")
        if tuple(s.shape) != sshape or s.dtype != torch.float32:
            raise ValueError(f"{what}: {name}_scale must be {sshape} float32")
    if out_dtype not in DTYPES:
        raise TypeError(f"{what}: out dtype {out_dtype} not in {list(DTYPES)}")
    B, S, H, D = r.shape
    out = torch.empty(r.shape, dtype=out_dtype, device=r.device)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    _build.call(
        "repro_rwkv6_scan_int8", r.data_ptr(), r_scale.data_ptr(), k.data_ptr(),
        k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), B, S, H, D, DTYPES[out_dtype], DTYPES[w.dtype],
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    return out, state
