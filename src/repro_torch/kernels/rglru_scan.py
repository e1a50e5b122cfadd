"""Launch wrappers of the CUDA RG-LRU scans (``csrc/rglru_scan.cu``): float
x, and int8 x with row scales.

Replace ``repro/kernels/rglru_scan.py::rglru_scan`` and ``::rglru_scan_int8``.
Each wrapper checks its inputs, allocates the output and launches on the
current stream; it never falls back.  Callers go through
:func:`repro_torch.kernels.ops.rglru_scan` and
:func:`repro_torch.kernels.ops.rglru_scan_q8`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(what: str, a: torch.Tensor, tensors) -> None:
    for name, t in tensors:
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if a.dim() != 3 or a.dtype != torch.float32:
        raise TypeError(f"{what}: a {tuple(a.shape)} {a.dtype} must be (B, S, W) float32")


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x (B, S, W) float32 -> every h_t (B, S, W) float32.  The recurrent
    block computes its gates in float32, so the kernel is built for that alone."""
    what = "rglru_scan"
    _check(what, a, (("a", a), ("x", x)))
    if x.shape != a.shape or x.dtype != torch.float32:
        raise ValueError(f"{what}: x {tuple(x.shape)} {x.dtype} must be float32 shaped "
                         f"like a {tuple(a.shape)}")
    B, S, W = x.shape
    y = torch.empty_like(x)
    _build.call("repro_rglru_scan", a.data_ptr(), x.data_ptr(), y.data_ptr(), B, S, W,
                torch.cuda.current_stream(x.device).cuda_stream)
    return y


def rglru_scan_int8(a: torch.Tensor, x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """a (B, S, W) float32, x (B, S, W) int8 with (B, S, 1) float32 row
    scales -> every h_t (B, S, W) float32 (the gated input it stands for is
    float32)."""
    what = "rglru_scan_int8"
    _check(what, a, (("a", a), ("x", x), ("x_scale", x_scale)))
    B, S, W = a.shape
    if x.shape != a.shape or x.dtype != torch.int8:
        raise ValueError(f"{what}: x {tuple(x.shape)} {x.dtype} must be int8 shaped like a "
                         f"{tuple(a.shape)}")
    if tuple(x_scale.shape) != (B, S, 1) or x_scale.dtype != torch.float32:
        raise ValueError(f"{what}: x_scale must be {(B, S, 1)} float32")
    y = torch.empty_like(a)
    _build.call("repro_rglru_scan_int8", a.data_ptr(), x.data_ptr(), x_scale.data_ptr(),
                y.data_ptr(), B, S, W, torch.cuda.current_stream(a.device).cuda_stream)
    return y
