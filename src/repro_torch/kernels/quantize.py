"""Launch wrapper of the CUDA row quantizer (``csrc/quantize.cu``).

Replaces ``repro/kernels/quantize.py::_quantize_rows``.  The wrapper checks
its inputs, picks the kernel's route from the row's shape and the bases'
alignment (:func:`quantize_plan`), allocates ``q`` and the scales and
launches on the current stream; it never falls back.  Callers go through
:func:`repro_torch.kernels.ops.quantize_int8` (and the int8-fused ops, which
quantize K and V, r, k and v, or the RG-LRU input through it).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

# route codes of csrc/quantize.cu (ROUTE_*) and the limits it routes by
QUANT_ROUTES = {"narrow": 0, "wide": 1, "scalar": 2}
NARROW_MAX_BYTES = 512      # a row on the narrow route: at most 32 lanes of 16 bytes
WIDE_MAX_PIECES = 128 * 8   # WIDE_THREADS x WIDE_PIECES 16-byte pieces a row


def quantize_plan(R: int, N: int, dtype: torch.dtype, aligned: bool) -> str:
    """The route of ``quantize_rows`` for R rows of N elements of ``dtype``;
    ``aligned``: x (and a noise tensor) start on a 16-byte boundary.

    ``narrow``: rows of 16-byte multiples up to NARROW_MAX_BYTES, a group of
    lanes a row; ``wide``: longer rows of 16-byte multiples up to
    WIDE_MAX_PIECES pieces, a block a row; ``scalar``: every other shape, a
    warp a row, one element a lane a load.  Raises on shapes no route takes."""
    if R <= 0 or N <= 0:
        raise ValueError(f"quantize_plan: R={R} N={N} must be positive")
    if dtype not in DTYPES:
        raise TypeError(f"quantize_plan: dtype {dtype} not in {list(DTYPES)}")
    row_bytes = N * torch.empty((), dtype=dtype).element_size()
    if not aligned or row_bytes % 16:
        return "scalar"
    if row_bytes <= NARROW_MAX_BYTES:
        return "narrow"
    return "wide" if row_bytes // 16 <= WIDE_MAX_PIECES else "scalar"


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
    aligned = x.data_ptr() % 16 == 0
    if isinstance(noise, torch.Tensor):
        if (noise.shape != x.shape or noise.dtype != torch.float32
                or noise.device != x.device or not noise.is_contiguous()):
            raise ValueError("quantize_rows: noise must be a contiguous float32 "
                             f"tensor shaped like x {tuple(x.shape)} on {x.device}")
        noise_ptr, noise_const = noise.data_ptr(), 0.0
        aligned = aligned and noise_ptr % 16 == 0
    else:
        noise_ptr, noise_const = None, float(noise)
    route = quantize_plan(R, N, x.dtype, aligned)
    q = torch.empty((R, N), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    _build.call(
        "repro_quantize_rows", x.data_ptr(), noise_ptr, noise_const, q.data_ptr(),
        scale.data_ptr(), R, N, DTYPES[x.dtype], QUANT_ROUTES[route],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return q, scale
