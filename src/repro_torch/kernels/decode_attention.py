"""Launch wrappers of the CUDA decode attention kernels
(``csrc/decode_attention.cu``): native cache and int8 cache.

Replace ``repro/kernels/decode_attention.py::decode_attention`` and
``::decode_attention_int8``.  Callers go through
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_attention_inputs


def _check_cache(q, k, v, valid_len, what):
    B, one, H, D = q.shape
    if one != 1:
        raise ValueError(f"{what}: q must be (B, 1, H, D), got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{what}: H={H} not a multiple of Hkv={k.shape[2]}")
    if valid_len.shape != (B,) or valid_len.dtype != torch.int32:
        raise ValueError(f"{what}: valid_len must be (B,) int32")


def _window(window: Optional[int]) -> int:
    if window is not None and window <= 0:
        raise ValueError("decode_attention: window must be positive")
    return int(window or 0)


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, D)
    k: torch.Tensor,          # (B, Skv, Hkv, D) cache
    v: torch.Tensor,
    valid_len: torch.Tensor,  # (B,) int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    what = "decode_attention"
    check_attention_inputs(q, (("q", q), ("k", k), ("v", v), ("valid_len", valid_len)), what)
    _check_cache(q, k, v, valid_len, what)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype")
    B, _, H, D = q.shape
    out = torch.empty_like(q)
    _build.call(
        "repro_decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid_len.data_ptr(), out.data_ptr(), B, k.shape[1], H, k.shape[2], D,
        _window(window), DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def decode_attention_int8(
    q: torch.Tensor,          # (B, 1, H, D)
    k: torch.Tensor,          # (B, Skv, Hkv, D) int8
    k_scale: torch.Tensor,    # (B, Skv, Hkv, 1) f32
    v: torch.Tensor,          # (B, Skv, Hkv, D) int8
    v_scale: torch.Tensor,    # (B, Skv, Hkv, 1) f32
    valid_len: torch.Tensor,  # (B,) int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    what = "decode_attention_int8"
    check_attention_inputs(
        q, (("q", q), ("k", k), ("k_scale", k_scale), ("v", v), ("v_scale", v_scale),
            ("valid_len", valid_len)), what)
    _check_cache(q, k, v, valid_len, what)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{what}: k and v must be int8")
    sshape = tuple(k.shape[:3]) + (1,)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != sshape or s.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be {sshape} float32")
    B, _, H, D = q.shape
    out = torch.empty_like(q)
    _build.call(
        "repro_decode_attention_int8", q.data_ptr(), k.data_ptr(), k_scale.data_ptr(),
        v.data_ptr(), v_scale.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        B, k.shape[1], H, k.shape[2], D, _window(window), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out
