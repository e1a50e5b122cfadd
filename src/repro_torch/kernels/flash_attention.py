"""Launch wrappers of the CUDA flash attention kernels
(``csrc/flash_attention.cu``): float K/V and int8 K/V with row scales.

Replace ``repro/kernels/flash_attention.py::flash_attention_fwd`` and
``::flash_attention_int8_fwd``.  Each wrapper checks its inputs, allocates
the output and launches on the current stream; it never falls back.
Callers go through :func:`repro_torch.kernels.ops.flash_attention` and
:func:`repro_torch.kernels.ops.flash_attention_q8`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the smoke configs, whisper-medium, the dense/MoE/VL configs, recurrentgemma-2b
HEAD_DIMS = (16, 32, 64, 128, 256)


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


def check_aligned(tensors, what: str) -> None:
    """The kernels copy rows in 16-byte pieces (cp.async, ldmatrix): every
    base pointer must be 16-byte aligned (a row of D >= 16 values is a
    multiple of 16 bytes, so every row then is)."""
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary "
                             f"(data_ptr {t.data_ptr():#x})")


def _check_qkv(q, k, v, window, what):
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{what}: H={H} not a multiple of Hkv={k.shape[2]}")
    if window is not None and window <= 0:
        raise ValueError(f"{what}: window must be positive")


def flash_attention_fwd(
    q: torch.Tensor,        # (B, Sq, H, D)
    k: torch.Tensor,        # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    check_attention_inputs(q, (("q", q), ("k", k), ("v", v)), "flash_attention")
    _check_qkv(q, k, v, window, "flash_attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:     # the tensor-core kernel's cp.async / ldmatrix
        check_aligned((("q", q), ("k", k), ("v", v), ("out", out)), "flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.call(
        "repro_flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Skv, H, Hkv, D, int(causal), int(window or 0),
        DTYPES[q.dtype], stream,
    )
    return out


def flash_attention_int8_fwd(
    q: torch.Tensor,          # (B, Sq, H, D) float32 / bfloat16
    k: torch.Tensor,          # (B, Skv, Hkv, D) int8
    k_scale: torch.Tensor,    # (B, Skv, Hkv, 1) float32 row scales
    v: torch.Tensor,          # (B, Skv, Hkv, D) int8
    v_scale: torch.Tensor,    # (B, Skv, Hkv, 1) float32
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention over int8 K/V, dequantized tile by tile on chip."""
    what = "flash_attention_int8"
    check_attention_inputs(
        q, (("q", q), ("k", k), ("k_scale", k_scale), ("v", v), ("v_scale", v_scale)), what)
    _check_qkv(q, k, v, window, what)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{what}: k and v must be int8")
    sshape = tuple(k.shape[:3]) + (1,)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != sshape or s.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be {sshape} float32")
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:     # the tensor-core kernel's cp.async / ldmatrix
        check_aligned((("q", q), ("k", k), ("v", v), ("out", out)), what)
    _build.call(
        "repro_flash_attention_int8_fwd", q.data_ptr(), k.data_ptr(), k_scale.data_ptr(),
        v.data_ptr(), v_scale.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], H,
        k.shape[2], D, int(causal), int(window or 0), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out
