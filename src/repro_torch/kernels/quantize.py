"""Launch wrapper of the CUDA row quantizer (``csrc/quantize.cu``).

Replaces ``repro/kernels/quantize.py::_quantize_rows``.  The wrapper checks
its inputs, allocates ``q`` and the scales and launches on the current
stream; it never falls back.  Callers go through
:func:`repro_torch.kernels.ops.quantize_int8` (and the int8-fused attention
op, which quantizes K and V through it).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES


def quantize_rows(
    x: torch.Tensor,                       # (R, N) float32 / bfloat16
    noise: Union[torch.Tensor, float],     # (R, N) float32, or one value for all
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8 (R, N), scale float32 (R, 1)), bit-identical to the TPU kernel."""
    if x.dim() != 2 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"quantize_rows: x must be a contiguous 2-D CUDA tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"quantize_rows: x dtype {x.dtype} not in {list(DTYPES)}")
    R, N = x.shape
    if isinstance(noise, torch.Tensor):
        if (noise.shape != x.shape or noise.dtype != torch.float32
                or noise.device != x.device or not noise.is_contiguous()):
            raise ValueError("quantize_rows: noise must be a contiguous float32 "
                             f"tensor shaped like x {tuple(x.shape)} on {x.device}")
        noise_ptr, noise_const = noise.data_ptr(), 0.0
    else:
        noise_ptr, noise_const = None, float(noise)
    q = torch.empty((R, N), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    _build.call(
        "repro_quantize_rows", x.data_ptr(), noise_ptr, noise_const, q.data_ptr(),
        scale.data_ptr(), R, N, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return q, scale
