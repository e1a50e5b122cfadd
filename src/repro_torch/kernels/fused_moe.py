"""Fused MoE layer of the port: routing in plain PyTorch, then the CUDA
expert GEMM and combine kernels (``csrc/fused_moe.cu``).

Replaces ``repro/kernels/fused_moe.py``: :func:`moe_routing` is its
``moe_routing`` (the reference keeps routing outside the kernels too: top-k
and a stable sort), :func:`fused_moe_gemm` and :func:`fused_moe_combine`
launch the kernels that replace ``fused_moe_gemm`` and ``fused_moe_combine``.
Callers go through :mod:`repro_torch.kernels.ops`, whose ``fused_moe_mlp``
wires the three together (the reference's ``fused_moe_mlp_fwd``) through
wrappers that count the launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import DTYPES

MAX_K = 32          # slots per token the combine kernel takes (csrc/fused_moe.cu)


def moe_routing(
    x: torch.Tensor,               # (T, d) tokens
    router: torch.Tensor,          # (d, E)
    k: int,
    capacity: int,
) -> Tuple[torch.Tensor, ...]:
    """Top-k routing + capacity-slot assignment, on either device and with
    no host sync (the decode loop runs it 48 times a step).

    Returns ``(slot_tok, slot_gate, st, slot, keep, aux)``:
      * ``slot_tok``  (E·C, 1) int32 — token per capacity slot, ``T`` if empty;
      * ``slot_gate`` (E·C, 1) f32   — normalized gate per slot, 0 if empty;
      * ``st``/``slot``/``keep``     — the (T·k,) tables in dispatch order
        (token, slot with ``E·C`` for a dropped copy, kept mask);
      * ``aux``                      — the Switch load-balance loss.
    """
    T = x.shape[0]
    E = router.shape[1]
    S = E * capacity
    st, sg, slot, keep, aux = R.route_top_k(x, router, k, capacity)
    # dropped copies all write the extra row S, which is cut off
    slot_tok = torch.full((S + 1,), T, dtype=torch.int32, device=x.device).scatter_(
        0, slot, st.to(torch.int32))[:S]
    slot_gate = torch.zeros(S + 1, dtype=torch.float32, device=x.device).scatter_(
        0, slot, torch.where(keep, sg, 0.0))[:S]
    return slot_tok[:, None], slot_gate[:, None], st, slot, keep, aux


def _check(what, tensors, x):
    for name, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def fused_moe_gemm(
    x: torch.Tensor,               # (T, d)
    wg: torch.Tensor,              # (E, d, f)
    wu: torch.Tensor,              # (E, d, f)
    wo: torch.Tensor,              # (E, f, d)
    slot_tok: torch.Tensor,        # (E*C, 1) int32
    slot_gate: torch.Tensor,       # (E*C, 1) f32
) -> torch.Tensor:
    """Gathered, gated expert SwiGLU per slot on the card -> (E·C, d)."""
    what = "fused_moe_gemm"
    _check(what, (("x", x), ("wg", wg), ("wu", wu), ("wo", wo), ("slot_tok", slot_tok),
                  ("slot_gate", slot_gate)), x)
    T, d = x.shape
    E, _, f = wg.shape
    S = slot_tok.shape[0]
    if x.dtype not in DTYPES or any(w.dtype != x.dtype for w in (wg, wu, wo)):
        raise TypeError(f"{what}: x, wg, wu, wo must share one dtype of {list(DTYPES)}")
    if (tuple(wg.shape) != (E, d, f) or wu.shape != wg.shape or tuple(wo.shape) != (E, f, d)
            or S % E or tuple(slot_tok.shape) != (S, 1)
            or tuple(slot_gate.shape) != (S, 1)):
        raise ValueError(f"{what}: x {tuple(x.shape)} wg {tuple(wg.shape)} wu "
                         f"{tuple(wu.shape)} wo {tuple(wo.shape)} slot_tok "
                         f"{tuple(slot_tok.shape)} slot_gate {tuple(slot_gate.shape)}")
    if slot_tok.dtype != torch.int32 or slot_gate.dtype != torch.float32:
        raise TypeError(f"{what}: slot_tok must be int32 and slot_gate float32")
    if d % 16 or f % 16:
        raise NotImplementedError(f"{what}: d={d} and f={f} must be multiples of 16")
    h = torch.empty((S, f), dtype=torch.float32, device=x.device)
    y = torch.empty((S, d), dtype=x.dtype, device=x.device)
    _build.call(
        "repro_fused_moe_gemm", x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wo.data_ptr(),
        slot_tok.data_ptr(), slot_gate.data_ptr(), h.data_ptr(), y.data_ptr(),
        T, d, f, E, S // E, DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def fused_moe_combine(
    y: torch.Tensor,               # (E*C, d) gated slot rows
    slot_tok: torch.Tensor,        # (E*C, 1) int32, T for an empty slot
    T: int,
) -> torch.Tensor:
    """Sum of each token's slot rows, in ascending slot order, on the card -> (T, d)."""
    what = "fused_moe_combine"
    _check(what, (("y", y), ("slot_tok", slot_tok)), y)
    S, d = y.shape
    if y.dtype not in DTYPES:
        raise TypeError(f"{what}: y dtype {y.dtype} not in {list(DTYPES)}")
    if tuple(slot_tok.shape) != (S, 1) or slot_tok.dtype != torch.int32:
        raise ValueError(f"{what}: slot_tok must be ({S}, 1) int32")
    if d % 4:
        raise NotImplementedError(f"{what}: d={d} must be a multiple of 4")
    out = torch.empty((T, d), dtype=y.dtype, device=y.device)
    counts = torch.empty(T, dtype=torch.int32, device=y.device)
    lists = torch.empty((T, MAX_K), dtype=torch.int32, device=y.device)
    _build.call(
        "repro_fused_moe_combine", y.data_ptr(), slot_tok.data_ptr(), out.data_ptr(),
        counts.data_ptr(), lists.data_ptr(), T, d, S, DTYPES[y.dtype],
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    return out

