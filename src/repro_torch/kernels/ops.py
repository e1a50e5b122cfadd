"""Public kernel ops of the port (counterpart of ``repro.kernels.ops``).

Each op picks its path from where its tensors lie:

* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`;
* a CUDA tensor launches the hand-written CUDA kernel, or raises.  There is
  no fallback and no ``use_kernel`` switch on the card;
* a ``meta`` tensor (the dry run's trace, :mod:`repro_torch.launch.dryrun`)
  takes the meta route: the kernel's outputs and scratch, made without any
  arithmetic, and the kernel's operations and bytes reported to the active
  count (:func:`repro_torch.roofline.cost.kernel_cost`) from the formulas of
  its bound.  A meta tensor holds no data, so there is nothing to compute.

The training ops are ``torch.autograd.Function``s with the reference's
``custom_vjp`` semantics: the forward runs the kernel (or, on the CPU, its
plain version) and saves only its inputs — int8 activations and their
scales for the int8-fused ops — and the backward recomputes through the
plain attention, MoE or scan math (``repro/kernels/ops.py:60-69, 142-153,
271-289, 316-475``).  That recompute is the reference's backward, not a
fallback: the JAX package has no backward kernel either.

``LAUNCHES`` counts kernel launches per kernel (plain integers, CUDA path
only), so a run can show that it went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import fused_moe as FM
from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd
from repro_torch.kernels.quantize import quantize_rows
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru_scan_cuda
from repro_torch.kernels.rglru_scan import rglru_scan_int8 as _rglru_scan_int8_cuda
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6_scan_cuda
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_int8 as _rwkv6_scan_int8_cuda
from repro_torch.roofline import cost as C

LAUNCHES: Dict[str, int] = {
    "flash_attention": 0,
    "flash_attention_q8": 0,
    "quantize_int8": 0,
    "decode_attention": 0,
    "decode_attention_int8": 0,
    "paged_decode_attention": 0,
    "paged_decode_attention_int8": 0,
    "fused_moe_gemm": 0,
    "fused_moe_combine": 0,
    "rwkv6_scan": 0,
    "rwkv6_scan_q8": 0,
    "rglru_scan": 0,
    "rglru_scan_q8": 0,
}

# public ops made only of counted ops: no kernel, so no counter of their own
COMPOSITE_OPS: Dict[str, Tuple[str, ...]] = {
    "fused_moe_mlp": ("fused_moe_gemm", "fused_moe_combine"),
    "fused_moe_local": ("fused_moe_gemm", "fused_moe_combine"),
}

# no kernel: an elementwise product the reference also leaves to the compiler
dequantize_int8 = R.dequantize_int8_ref


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _meta_kernel(name: str, flops: float, inputs, outputs, scratch=(), read: int = 0):
    """The meta route of kernel ``name``: ``outputs`` (and ``scratch``, alive
    for the call) are meta tensors the caller made; the kernel's work goes
    to the active count: ``flops`` and every input read once (``read``
    bytes besides), every output written once."""
    C.kernel_cost(name, flops, read + C.nbytes(
        *(t for t in inputs if isinstance(t, torch.Tensor)), *outputs))
    return outputs[0] if len(outputs) == 1 else tuple(outputs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# int8 row quantizer
# ---------------------------------------------------------------------------


def quantize_int8(
    x: torch.Tensor,                      # (R, N) float
    noise: Union[torch.Tensor, float],    # (R, N) in [0, 1), or one value for all
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``scale = max(absmax/127, 1e-12)``,
    ``q = clip(floor(x/scale + noise), -127, 127)``.  -> (q int8, scale f32 (R, 1))."""
    if x.is_meta:
        return _meta_kernel("quantize_int8", 0.0, (x, noise),
                            (_meta(x.shape, torch.int8), _meta((x.shape[0], 1), torch.float32)))
    if not x.is_cuda:
        return R.quantize_int8_ref(x, noise)
    out = quantize_rows(x, noise)
    LAUNCHES["quantize_int8"] += 1
    return out


def _quantize_q8(x: torch.Tensor, row_absmax: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-half-up int8 over the last axis of any shape (the training
    quantizer: constant noise 0.5).  ``row_absmax`` (..., 1), where given,
    is the absmax of a wider row of which ``x`` holds columns: it rides as
    four more columns (16 bytes of float32), so the quantizer's own absmax
    is that row's and so is the scale, and they are dropped from ``q``."""
    if row_absmax is not None:
        n = x.shape[-1]
        wide = torch.cat([x, row_absmax.to(x.dtype).expand(x.shape[:-1] + (4,))], dim=-1)
        q, s = _quantize_q8(wide)
        return q[..., :n].contiguous(), s
    q, s = quantize_int8(x.reshape(-1, x.shape[-1]).contiguous(), 0.5)
    return q.view(x.shape), s.view(x.shape[:-1] + (1,))


# ---------------------------------------------------------------------------
# flash attention (differentiable)
# ---------------------------------------------------------------------------


def _attention_ops(q, k, causal, window) -> float:
    B, Sq, H, D = q.shape
    return C.attention_ops(B, H, Sq, k.shape[1], D, causal, window)


def _attention_vjp(q, k, v, g, causal, window):
    """Gradients of the plain attention at (q, k, v) against ``g``."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = R.flash_attention_ref(qd, kd, vd, causal=causal, window=window)
        return torch.autograd.grad(out, (qd, kd, vd), g)


def _no_heads(q: torch.Tensor) -> bool:
    """A tensor-parallel rank whose block of query heads is empty (the
    last ranks of a padded split): the attention ops return the empty
    output and launch nothing, and their backward the zero gradients, so
    the rank's graph, and the collectives around it, are its peers'."""
    return q.shape[2] == 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if _no_heads(q):
            return torch.empty_like(q)
        if q.is_meta:
            return _meta_kernel("flash_attention", _attention_ops(q, k, causal, window),
                                (q, k, v), (torch.empty_like(q),))
        if not q.is_cuda:
            return R.flash_attention_ref(q, k, v, causal=causal, window=window)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        LAUNCHES["flash_attention"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if _no_heads(q):
            return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v), None, None
        return (*_attention_vjp(q, k, v, g, ctx.causal, ctx.window), None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D) in q.dtype."""
    return _FlashAttention.apply(q, k, v, causal, window)


class _FlashAttentionQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.empty = _no_heads(q)
        if ctx.empty:
            ctx.save_for_backward(q, k, v)
            return torch.empty_like(q)
        kq, ks = _quantize_q8(k)
        vq, vs = _quantize_q8(v)
        ctx.save_for_backward(q, kq, ks, vq, vs)
        ctx.causal, ctx.window = causal, window
        ctx.k_dtype, ctx.v_dtype = k.dtype, v.dtype
        if q.is_meta:
            return _meta_kernel("flash_attention_q8", _attention_ops(q, k, causal, window),
                                (q, kq, ks, vq, vs), (torch.empty_like(q),))
        if not q.is_cuda:
            return R.flash_attention_ref(
                q, R.dequantize_int8_ref(kq, ks), R.dequantize_int8_ref(vq, vs),
                causal=causal, window=window)
        out = flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=causal, window=window)
        LAUNCHES["flash_attention_q8"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.empty:
            return (*(torch.zeros_like(t) for t in ctx.saved_tensors), None, None)
        # straight-through across the rounding: the base op's gradient at
        # the dequantized K/V, cast back to the primal dtypes
        q, kq, ks, vq, vs = ctx.saved_tensors
        dq, dk, dv = _attention_vjp(
            q, R.dequantize_int8_ref(kq, ks), R.dequantize_int8_ref(vq, vs), g,
            ctx.causal, ctx.window)
        return dq.to(q.dtype), dk.to(ctx.k_dtype), dv.to(ctx.v_dtype), None, None


def flash_attention_q8(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Int8-fused training attention: K/V are quantized per row (round half
    up), attention runs over the int8 K/V with f32 accumulation, and the
    backward residuals are the int8 K/V + scales instead of float K/V."""
    return _FlashAttentionQ8.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# decode attention (inference only — no backward)
# ---------------------------------------------------------------------------


def _meta_decode(name, q, inputs, capacity, window, read=0):
    """Decode's meta route: a meta tensor holds no valid lengths, so every
    row of the cache (of the window) counts as live, as a full cache's
    would; the split's partial states are the scratch."""
    B, _, H, D = q.shape
    plan = DA.split_plan(capacity, 1, DA.chunk_rows(D, q.dtype))
    rows = min(window or capacity, capacity)
    return _meta_kernel(name, 4.0 * D * B * H * rows, inputs, (torch.empty_like(q),),
                        (_meta(B * H * plan.n_chunks * (D + 2), torch.float32),), read)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query row per (batch, head) against a contiguous cache; positions
    ``< valid_len[b]`` attend.  q (B, 1, H, D), k/v (B, Skv, Hkv, D)."""
    if _no_heads(q):
        return torch.empty_like(q)
    if q.is_meta:
        return _meta_decode("decode_attention", q, (q, k, v, valid_len), k.shape[1], window)
    if not q.is_cuda:
        return R.decode_attention_ref(q, k, v, valid_len, window=window)
    out = DA.decode_attention(q, k, v, valid_len, window=window)
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_int8(
    q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
    v: torch.Tensor, v_scale: torch.Tensor, valid_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`decode_attention` over an int8 cache + per-row f32 scales,
    dequantized inside the kernel."""
    if _no_heads(q):
        return torch.empty_like(q)
    if q.is_meta:
        return _meta_decode("decode_attention_int8", q,
                            (q, k, k_scale, v, v_scale, valid_len), k.shape[1], window)
    if not q.is_cuda:
        return R.decode_attention_int8_ref(
            q, k, k_scale, v, v_scale, valid_len, window=window)
    out = DA.decode_attention_int8(q, k, k_scale, v, v_scale, valid_len, window=window)
    LAUNCHES["decode_attention_int8"] += 1
    return out


def _table_bytes(table, *pools) -> int:
    """Bytes of the pages a block table addresses in each pool (what a paged
    kernel reads of it)."""
    return sum(table.numel() * p[0].numel() * p.element_size() for p in pools)


def paged_decode_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, valid_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`decode_attention` over the pages of a shared pool: row ``r`` of
    sequence ``b`` is row ``r % page_size`` of page ``block_table[b, r //
    page_size]``.  q (B, 1, H, D), pages (P, page_size, Hkv, D), table (B, NP)."""
    if q.is_meta:
        return _meta_decode("paged_decode_attention", q, (q, block_table, valid_len),
                            block_table.shape[1] * k_pages.shape[1], window,
                            _table_bytes(block_table, k_pages, v_pages))
    if not q.is_cuda:
        return R.paged_decode_attention_ref(
            q, k_pages, v_pages, block_table, valid_len, window=window)
    out = DA.paged_decode_attention(q, k_pages, v_pages, block_table, valid_len,
                                    window=window)
    LAUNCHES["paged_decode_attention"] += 1
    return out


def paged_decode_attention_int8(
    q: torch.Tensor, k_pages: torch.Tensor, k_scales: torch.Tensor,
    v_pages: torch.Tensor, v_scales: torch.Tensor,
    block_table: torch.Tensor, valid_len: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`paged_decode_attention` over int8 pages + per-row f32 scales,
    dequantized inside the kernel."""
    if _no_heads(q):
        return torch.empty_like(q)
    if q.is_meta:
        return _meta_decode("paged_decode_attention_int8", q, (q, block_table, valid_len),
                            block_table.shape[1] * k_pages.shape[1], window,
                            _table_bytes(block_table, k_pages, k_scales, v_pages, v_scales))
    if not q.is_cuda:
        return R.paged_decode_attention_int8_ref(
            q, k_pages, k_scales, v_pages, v_scales, block_table, valid_len, window=window)
    out = DA.paged_decode_attention_int8(q, k_pages, k_scales, v_pages, v_scales,
                                         block_table, valid_len, window=window)
    LAUNCHES["paged_decode_attention_int8"] += 1
    return out


# ---------------------------------------------------------------------------
# fused MoE (differentiable)
# ---------------------------------------------------------------------------


def fused_moe_gemm(
    x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor,
    slot_tok: torch.Tensor, slot_gate: torch.Tensor,
) -> torch.Tensor:
    """Dispatch gather + expert SwiGLU in float32 + gate per capacity slot.
    x (T, d), wg/wu (E, d, f), wo (E, f, d), slot_tok (E·C, 1) int32 (``T``
    for an empty slot), slot_gate (E·C, 1) f32 -> (E·C, d) in x.dtype."""
    if x.is_meta:
        # every slot counts as live: a meta slot table holds no tokens
        S, (E, d, f) = slot_tok.shape[0], wg.shape
        return _meta_kernel("fused_moe_gemm", 6.0 * S * d * f,
                            (x, wg, wu, wo, slot_tok, slot_gate), (_meta((S, d), x.dtype),),
                            (_meta((S, f), torch.float32),))
    if not x.is_cuda:
        return R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate)
    out = FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)
    LAUNCHES["fused_moe_gemm"] += 1
    return out


def fused_moe_combine(y: torch.Tensor, slot_tok: torch.Tensor, T: int) -> torch.Tensor:
    """``out[t] = Σ y[s]`` over the slots of token t, in float32, in
    ascending slot order, cast once.  y (E·C, d) -> (T, d)."""
    if y.is_meta:
        S, d = y.shape
        scratch = ((_meta(T, torch.int32), _meta((T, FM.MAX_K), torch.int32))
                   if FM.combine_route(S, T, d) == "two_pass" else ())
        return _meta_kernel("fused_moe_combine", float(S * d), (y, slot_tok),
                            (_meta((T, d), y.dtype),), scratch)
    if not y.is_cuda:
        return R.fused_moe_combine_ref(y, slot_tok, T)
    out = FM.fused_moe_combine(y, slot_tok, T)
    LAUNCHES["fused_moe_combine"] += 1
    return out


class _FusedMoE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, router, wg, wu, wo, k, capacity):
        ctx.save_for_backward(x, router, wg, wu, wo)
        ctx.k, ctx.capacity = k, capacity
        slot_tok, slot_gate, _, _, _, aux = FM.moe_routing(x, router, k, capacity)
        y = fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)
        return fused_moe_combine(y, slot_tok, x.shape[0]), aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        # recompute through the oracle: routing, dispatch and the expert
        # intermediates, rather than saving E·C·f floats (as the reference)
        with torch.enable_grad():
            args = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
            out, aux = R.fused_moe_mlp_ref(*args, ctx.k, ctx.capacity)
            grads = torch.autograd.grad((out, aux), args, (g_out, g_aux), allow_unused=True)
        return (*grads, None, None)


def fused_moe_mlp(
    x: torch.Tensor,               # (T, d) tokens
    router: torch.Tensor,          # (d, E)
    wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor,   # expert SwiGLU weights
    *,
    k: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE layer: routing in plain PyTorch, then the expert GEMM and
    the combine (kernels on the card, their plain versions on the CPU).
    -> (out (T, d), aux loss f32); the backward recomputes through
    :func:`~repro_torch.kernels.ref.fused_moe_mlp_ref`."""
    return _FusedMoE.apply(x, router, wg, wu, wo, k, capacity)


class _LocalMoE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, router, wg, wu, wo, k, capacity, first_expert):
        ctx.save_for_backward(x, router, wg, wu, wo)
        ctx.k, ctx.capacity, ctx.first = k, capacity, first_expert
        slot_tok, slot_gate = FM.moe_routing(x, router, k, capacity)[:2]
        mine = slice(first_expert * capacity, (first_expert + wg.shape[0]) * capacity)
        y = fused_moe_gemm(x, wg, wu, wo, slot_tok[mine], slot_gate[mine])
        return fused_moe_combine(y, slot_tok[mine], x.shape[0])

    @staticmethod
    def backward(ctx, g_out):
        with torch.enable_grad():
            args = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = R.fused_moe_local_ref(*args, ctx.k, ctx.capacity, ctx.first)
            grads = torch.autograd.grad(out, args, g_out, allow_unused=True)
        return (*grads, None, None, None)


def fused_moe_local(
    x: torch.Tensor,               # (T, d) tokens
    router: torch.Tensor,          # (d, E) the whole router
    wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor,   # experts first_expert..
    *,
    k: int,
    capacity: int,
    first_expert: int,
) -> torch.Tensor:
    """An expert-parallel rank's part of the top-k MoE layer: routing over
    all E experts, then the expert GEMM and the combine kernels on the slot
    tables of the rank's experts ``first_expert ..`` alone.  -> the partial
    output (T, d) (its tokens' copies sent to other ranks' experts add
    nothing); the backward recomputes through
    :func:`~repro_torch.kernels.ref.fused_moe_local_ref`."""
    return _LocalMoE.apply(x, router, wg, wu, wo, k, capacity, first_expert)


# ---------------------------------------------------------------------------
# linear recurrences (differentiable)
# ---------------------------------------------------------------------------

WKV_CHUNK = 32    # the TPU kernel's chunk: the plain backward recomputes this many steps at once


def _rwkv6_vjp(r, k, v, w, u, g_out, g_state):
    """Gradients of the plain WKV-6 scan at (r, k, v, w, u), the reference's
    backward (``repro/kernels/ops.py:403-410``), recomputed ``WKV_CHUNK``
    steps at a time: one plain forward keeps the state at each chunk
    boundary, then each chunk is recomputed with autograd in reverse order,
    carrying dS.  The same function and per-step arithmetic as one vjp of
    the whole scan, with one chunk's intermediates alive at a time instead
    of every step's.  The output is cast to ``g_out.dtype`` before the vjp,
    as the int8-fused op's backward does; each gradient comes back in its
    input's dtype."""
    S = r.shape[1]
    starts = list(range(0, S, WKV_CHUNK))
    states = [None]
    with torch.no_grad():
        for c0 in starts[:-1]:
            c1 = c0 + WKV_CHUNK
            states.append(R.rwkv6_scan_ref(r[:, c0:c1], k[:, c0:c1], v[:, c0:c1],
                                           w[:, c0:c1], u, s0=states[-1])[1])
    grads = [torch.empty_like(t) for t in (r, k, v, w)]
    du = torch.zeros_like(u)
    ds = g_state.float()
    for c0, s0 in zip(reversed(starts), reversed(states)):
        c1 = min(c0 + WKV_CHUNK, S)
        with torch.enable_grad():
            leaves = [t[:, c0:c1].detach().requires_grad_() for t in (r, k, v, w)]
            ul = u.detach().requires_grad_()
            sl = None if s0 is None else s0.requires_grad_()
            out, s = R.rwkv6_scan_ref(*leaves, ul, s0=sl)
            inputs = (*leaves, ul) if sl is None else (*leaves, ul, sl)
            got = torch.autograd.grad((out.to(g_out.dtype), s), inputs,
                                      (g_out[:, c0:c1], ds))
        for dst, g in zip(grads, got[:4]):
            dst[:, c0:c1] = g
        du += got[4]
        if sl is not None:
            ds = got[5]
    return (*grads, du)


def _meta_wkv(name, r, inputs, out_dtype):
    B, S, H, D = r.shape
    return _meta_kernel(name, C.wkv6_ops(B, S, H, D), inputs,
                        (_meta(r.shape, out_dtype), _meta((B, H, D, D), torch.float32)))


class _RWKV6Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        if r.is_meta:
            return _meta_wkv("rwkv6_scan", r, (r, k, v, w, u), r.dtype)
        if not r.is_cuda:
            return R.rwkv6_scan_ref(r, k, v, w, u)
        out = _rwkv6_scan_cuda(r, k, v, w, u)
        LAUNCHES["rwkv6_scan"] += 1
        return out

    @staticmethod
    def backward(ctx, g_out, g_state):
        return _rwkv6_vjp(*ctx.saved_tensors, g_out, g_state)


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,  # (B, S, H, D)
    u: torch.Tensor,                                                    # (H, D) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 from a zero state: ``out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``.  -> (out (B, S, H, D) in r.dtype,
    final state (B, H, D, D) f32); the backward recomputes through the plain
    scan (:func:`_rwkv6_vjp`)."""
    return _RWKV6Scan.apply(r, k, v, w, u)


class _RWKV6ScanQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        (rq, rs), (kq, ks), (vq, vs) = (_quantize_q8(t) for t in (r, k, v))
        ctx.save_for_backward(rq, rs, kq, ks, vq, vs, w, u)
        ctx.dtypes = r.dtype, k.dtype, v.dtype
        if r.is_meta:
            return _meta_wkv("rwkv6_scan_q8", r, (rq, rs, kq, ks, vq, vs, w, u), r.dtype)
        if not r.is_cuda:
            out, s = R.rwkv6_scan_ref(R.dequantize_int8_ref(rq, rs), R.dequantize_int8_ref(kq, ks),
                                      R.dequantize_int8_ref(vq, vs), w.float(), u)
            return out.to(r.dtype), s
        out = _rwkv6_scan_int8_cuda(rq, rs, kq, ks, vq, vs, w, u, r.dtype)
        LAUNCHES["rwkv6_scan_q8"] += 1
        return out

    @staticmethod
    def backward(ctx, g_out, g_state):
        # straight-through across the rounding: the plain scan's gradients at
        # the dequantized r/k/v, cast back to their primal dtypes
        rq, rs, kq, ks, vq, vs, w, u = ctx.saved_tensors
        dr, dk, dv, dw, du = _rwkv6_vjp(
            R.dequantize_int8_ref(rq, rs), R.dequantize_int8_ref(kq, ks),
            R.dequantize_int8_ref(vq, vs), w, u, g_out, g_state)
        return (*(g.to(dt) for g, dt in zip((dr, dk, dv), ctx.dtypes)), dw, du)


def rwkv6_scan_q8(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,  # (B, S, H, D)
    u: torch.Tensor,                                                    # (H, D) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8-fused WKV-6: r/k/v are quantized per row (round half up), the scan
    runs over int8 + row scales with the decay and the bonus in float, and
    the backward residuals are the int8 r/k/v + scales.  -> (out in r.dtype,
    final state f32)."""
    return _RWKV6ScanQ8.apply(r, k, v, w, u)


def _rglru_vjp(a, x, g):
    """Gradients of the plain RG-LRU scan at (a, x), output cast to g's dtype."""
    with torch.enable_grad():
        ad, xd = a.detach().requires_grad_(), x.detach().requires_grad_()
        y = R.rglru_scan_ref(ad, xd).to(g.dtype)
        return torch.autograd.grad(y, (ad, xd), g)


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        if x.is_meta:
            return _meta_kernel("rglru_scan", 2.0 * x.numel(), (a, x), (torch.empty_like(x),))
        if not x.is_cuda:
            return R.rglru_scan_ref(a, x)
        y = _rglru_scan_cuda(a, x)
        LAUNCHES["rglru_scan"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return _rglru_vjp(*ctx.saved_tensors, g)


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + x_t`` from ``h_0 = 0`` with a float32 carry.
    a, x (B, S, W) -> every h_t (B, S, W) in x.dtype; the backward recomputes
    through the plain scan."""
    return _RGLRUScan.apply(a, x)


class _RGLRUScanQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x, row_absmax):
        xq, xs = _quantize_q8(x, row_absmax)
        ctx.save_for_backward(a, xq, xs)
        ctx.x_dtype = x.dtype
        if x.is_meta:
            return _meta_kernel("rglru_scan_q8", 2.0 * x.numel(), (a, xq, xs),
                                (torch.empty_like(a),)).to(x.dtype)
        if not x.is_cuda:
            return R.rglru_scan_ref(a, R.dequantize_int8_ref(xq, xs)).to(x.dtype)
        y = _rglru_scan_int8_cuda(a, xq, xs)
        LAUNCHES["rglru_scan_q8"] += 1
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        a, xq, xs = ctx.saved_tensors
        da, dx = _rglru_vjp(a, R.dequantize_int8_ref(xq, xs), g)
        return da.to(a.dtype), dx.to(ctx.x_dtype), None


def rglru_scan_q8(a: torch.Tensor, x: torch.Tensor,
                  row_absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int8-fused RG-LRU: the gated input is quantized per row of W (round
    half up) and dequantized inside the scan; the decay stays float32 and the
    backward residual is the int8 input + scales.  -> (B, S, W) in x.dtype.
    ``row_absmax`` (B, S, 1): the absmax of each whole row where x holds a
    tensor-parallel rank's channels of it (the row's scale is then the
    reference's, which quantizes the whole row)."""
    return _RGLRUScanQ8.apply(a, x, row_absmax)
