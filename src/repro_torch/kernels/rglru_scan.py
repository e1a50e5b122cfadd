"""Launch wrapper of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``).

Replaces ``repro/kernels/rglru_scan.py::rglru_scan``.  The wrapper checks
its inputs, allocates the output and launches on the current stream; it
never falls back.  Callers go through :func:`repro_torch.kernels.ops.rglru_scan`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a, x (B, S, W) float32 -> every h_t (B, S, W) float32.  The recurrent
    block computes its gates in float32, so the kernel is built for that alone."""
    what = "rglru_scan"
    for name, t in (("a", a), ("x", x)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"{what}: a {tuple(a.shape)} and x {tuple(x.shape)} "
                         f"must be one (B, S, W) shape")
    if a.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{what}: a {a.dtype} and x {x.dtype} must be float32")
    B, S, W = x.shape
    y = torch.empty_like(x)
    _build.call("repro_rglru_scan", a.data_ptr(), x.data_ptr(), y.data_ptr(), B, S, W,
                torch.cuda.current_stream(x.device).cuda_stream)
    return y
