"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

Each function is the mathematical definition, written for clarity not speed.
The CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold them
to the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel to them on
the card.  Masks and the 0-for-a-fully-masked-row rule follow
``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by repeating each kv head ``H/Hkv`` times."""
    hkv = k.shape[2]
    return k if hkv == n_heads else k.repeat_interleave(n_heads // hkv, dim=2)


def _masked_softmax_av(logits: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis where ``mask`` holds, rows with no live
    position give 0; then ``probs @ v``.  logits (B,H,Sq,Skv), v (B,Skv,H,D)."""
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def flash_attention_ref(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D)
    v: torch.Tensor,               # (B, Skv, Hkv, D)
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    return _masked_softmax_av(logits, mask[None, None], v).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,               # (B, 1, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D) cache
    v: torch.Tensor,               # (B, Skv, Hkv, D)
    valid_len: torch.Tensor,       # (B,) int — positions < valid_len attend
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, _, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = valid_len.to(device=q.device, dtype=torch.int64)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = k_pos < valid
    if window is not None:
        mask &= k_pos > (valid - 1 - window)
    return _masked_softmax_av(logits, mask[:, None, None, :], v).to(q.dtype)


def decode_attention_int8_ref(
    q: torch.Tensor,               # (B, 1, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D) int8 cache
    k_scale: torch.Tensor,         # (B, Skv, Hkv, 1) f32 per-row scales
    v: torch.Tensor,               # (B, Skv, Hkv, D) int8
    v_scale: torch.Tensor,         # (B, Skv, Hkv, 1) f32
    valid_len: torch.Tensor,       # (B,) int
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Dequantize the int8 cache, then dense decode (the fused kernel's target)."""
    kf = dequantize_int8_ref(k, k_scale, torch.float32)
    vf = dequantize_int8_ref(v, v_scale, torch.float32)
    return decode_attention_ref(q, kf, vf, valid_len, window=window)


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(P, page_size, Hkv, X) pages, (B, NP) table -> (B, NP*page_size, Hkv, X)."""
    B, NP = block_table.shape
    rows = pages[block_table.long()]                 # (B, NP, page_size, Hkv, X)
    return rows.reshape(B, NP * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_ref(
    q: torch.Tensor,               # (B, 1, H, D)
    k_pages: torch.Tensor,         # (P, page_size, Hkv, D) shared page pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,     # (B, NP) int page ids per sequence
    valid_len: torch.Tensor,       # (B,) int
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Gather each row's pages into a contiguous cache, then dense decode."""
    return decode_attention_ref(q, gather_pages(k_pages, block_table),
                                gather_pages(v_pages, block_table), valid_len,
                                window=window)


def paged_decode_attention_int8_ref(
    q: torch.Tensor,               # (B, 1, H, D)
    k_pages: torch.Tensor,         # (P, page_size, Hkv, D) int8
    k_scales: torch.Tensor,        # (P, page_size, Hkv, 1) f32
    v_pages: torch.Tensor,
    v_scales: torch.Tensor,
    block_table: torch.Tensor,     # (B, NP) int
    valid_len: torch.Tensor,       # (B,) int
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Gather int8 pages + scales, dequantize, then dense decode."""
    k = dequantize_int8_ref(gather_pages(k_pages, block_table),
                            gather_pages(k_scales, block_table))
    v = dequantize_int8_ref(gather_pages(v_pages, block_table),
                            gather_pages(v_scales, block_table))
    return decode_attention_ref(q, k, v, valid_len, window=window)


def quantize_int8_ref(
    x: torch.Tensor,                                  # (..., N) float
    noise: Union[torch.Tensor, float, None] = None,   # same shape (or one value), in [0, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: scale = max(absmax/127, 1e-12).

    ``noise=None`` rounds half to even (``torch.round``, as ``jnp.round``;
    the serve cache's quantizer); otherwise ``floor(x/scale + noise)`` —
    stochastic rounding with U[0,1) noise, round half up at a constant 0.5
    (the training quantizer, ``repro/kernels/quantize.py::_quantize_rows``).
    Returns (q int8, scale f32 (..., 1)).
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if noise is None:
        # as the JAX oracle computes it op by op: a true division by 127
        scale = torch.clamp(absmax / 127.0, min=1e-12)
        q = torch.round(xf / scale)
    else:
        # as the JAX kernel computes it: XLA folds the constant divisor into a
        # multiply by its float32 reciprocal (1 ulp off the division on some
        # rows); the division by the scale stays a true division
        scale = torch.clamp(absmax * (1.0 / 127.0), min=1e-12)
        q = torch.floor(xf / scale + torch.as_tensor(noise, dtype=torch.float32,
                                                      device=x.device))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_int8_ref(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _q8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Through the training quantizer (per row, round half up) and back, in f32."""
    return dequantize_int8_ref(*quantize_int8_ref(x, 0.5))


def flash_attention_q8_ref(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, Hkv, D) float
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention with K/V squeezed through per-row int8, round half up
    (constant noise 0.5): the int8-fused training attention."""
    return flash_attention_ref(q, _q8_roundtrip(k), _q8_roundtrip(v),
                               causal=causal, window=window)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def fused_moe_gemm_ref(
    x: torch.Tensor,               # (T, d) tokens
    wg: torch.Tensor,              # (E, d, f) gate proj
    wu: torch.Tensor,              # (E, d, f) up proj
    wo: torch.Tensor,              # (E, f, d) down proj
    slot_tok: torch.Tensor,        # (E*C, 1) int32, T for an empty slot
    slot_gate: torch.Tensor,       # (E*C, 1) f32, 0 for an empty slot
) -> torch.Tensor:
    """Gated expert SwiGLU per capacity slot, in float32 from the operands'
    dtype, cast once: ``y[s] = (silu(x[t_s] wg[e]) * (x[t_s] wu[e])) wo[e] *
    gate[s]`` with ``e = s // C``; an empty slot reads a zero row and gives
    exactly 0.  -> (E*C, d) in ``x.dtype``."""
    T, d = x.shape
    E = wg.shape[0]
    S = slot_tok.shape[0]
    tok = slot_tok.reshape(-1).long()
    live = tok < T
    xs = torch.where(live[:, None], x[tok.clamp(max=T - 1)].float(), 0.0)
    xs = xs.reshape(E, S // E, d)
    g = torch.bmm(xs, wg.float())
    u = torch.bmm(xs, wu.float())
    y = torch.bmm(torch.nn.functional.silu(g) * u, wo.float()).reshape(S, d)
    y = torch.where(live[:, None], y * slot_gate.float(), 0.0)
    return y.to(x.dtype)


def fused_moe_combine_ref(
    y: torch.Tensor,               # (E*C, d) gated slot rows
    slot_tok: torch.Tensor,        # (E*C, 1) int32, T for an empty slot
    T: int,
) -> torch.Tensor:
    """``out[t] = sum of y[s] over the slots s with slot_tok[s] == t``, in
    float32, added one row at a time in ascending slot order and cast once
    (the CUDA kernel's order, so the two agree bit for bit).  -> (T, d)."""
    S, d = y.shape
    tok = slot_tok.reshape(-1).long()
    # each token's slots in ascending order: a stable sort by token keeps the
    # slot order within a token, and a slot's rank is its place in that list;
    # empty slots (token T) sort last and are never added
    order = torch.argsort(tok, stable=True)
    st = tok[order]
    rank = torch.arange(S, device=y.device) - torch.searchsorted(st, st)
    n_add = int((rank * (st < T)).max()) + 1 if S else 0
    out = torch.zeros((T, d), dtype=torch.float32, device=y.device)
    yf = y.float()
    for r in range(n_add):
        sel = order[(rank == r) & (st < T)]
        out.index_add_(0, tok[sel], yf[sel])        # at most one row per token
    return out.to(y.dtype)


def route_top_k(x, router, k, capacity):
    """Top-k routing with renormalized gates, the Switch aux loss, and
    first-come capacity slots (``repro/kernels/fused_moe.py:54-106``).
    Returns ``(st, sg, slot, keep, aux)`` in dispatch order."""
    T = x.shape[0]
    E = router.shape[1]
    C = capacity
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    tok_frac = torch.nn.functional.one_hot(expert_ids, E).float().sum(dim=1).mean(dim=0)
    aux = E * torch.sum(tok_frac * probs.mean(dim=0))

    flat_expert = expert_ids.reshape(-1)                        # (T*k,)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], gate_vals.reshape(-1)[order]
    # per-expert counts without a host sync (bincount syncs on the card)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - offsets[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    return st, sg, slot, keep, aux


def fused_moe_mlp_ref(
    x: torch.Tensor,               # (T, d) tokens
    router: torch.Tensor,          # (d, E)
    wg: torch.Tensor,              # (E_here, d, f)
    wu: torch.Tensor,              # (E_here, d, f)
    wo: torch.Tensor,              # (E_here, f, d)
    k: int,
    capacity: int,
    first_expert: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-layout top-k MoE with SwiGLU experts, the oracle of
    ``repro/kernels/ref.py:141-190``: routing over the router's E experts,
    a (E_here*C, d) dispatch buffer, per-expert SwiGLU in the operands'
    dtype, and a scatter-add combine of the gated slot rows.  The weights
    hold experts ``first_expert ..`` (all E by default; an expert-parallel
    rank's own, whose slots are those of the whole routing): copies routed
    elsewhere add nothing.  -> (out (T, d), aux f32)."""
    T, d = x.shape
    E = wg.shape[0]
    C = capacity
    st, sg, slot, keep, aux = route_top_k(x, router, k, C)
    lo = first_expert * C
    keep = keep & (slot >= lo) & (slot < lo + E * C)
    slot = torch.where(keep, slot - lo, E * C)
    gathered = x[st] * keep[:, None].to(x.dtype)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, slot, gathered)[: E * C].reshape(E, C, d)
    g = torch.einsum("ecd,edf->ecf", buf, wg)
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    y = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(g) * u, wo).reshape(E * C, d)
    safe_slot = slot.clamp(max=E * C - 1)
    gate_w = (sg * keep).to(y.dtype)
    out = torch.zeros((T, d), dtype=y.dtype, device=x.device).index_add(
        0, st, y[safe_slot] * gate_w[:, None])
    return out, aux


def fused_moe_local_ref(x, router, wg, wu, wo, k: int, capacity: int,
                        first_expert: int) -> torch.Tensor:
    """The output part of experts ``first_expert ..`` (as many as ``wg``
    holds) of :func:`fused_moe_mlp_ref`: an expert-parallel rank's."""
    return fused_moe_mlp_ref(x, router, wg, wu, wo, k, capacity, first_expert)[0]


# ---------------------------------------------------------------------------
# Linear recurrences
# ---------------------------------------------------------------------------


def rglru_scan_ref(
    a: torch.Tensor,               # (B, S, W) decay in (0, 1)
    x: torch.Tensor,               # (B, S, W) gated input
    h0: Optional[torch.Tensor] = None,   # (B, W)
) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + x_t`` one step at a time in float32 from
    ``h0`` (zeros by default); returns every h_t in ``x.dtype``."""
    af, xf = a.float(), x.float()
    h = torch.zeros_like(xf[:, 0]) if h0 is None else h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys.append(h)
    return (torch.stack(ys, dim=1) if ys else xf).to(x.dtype)


def rwkv6_scan_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,  # (B, S, H, D)
    u: torch.Tensor,                                                    # (H, D)
    s0: Optional[torch.Tensor] = None,                                  # (B, H, D, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 one token at a time in float32:
    ``out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``.
    -> (out (B, S, H, D) in ``r.dtype``, final state (B, H, D, D) f32)."""
    B, S, H, D = r.shape
    s = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]           # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t], s + uf[..., :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    out = torch.stack(outs, dim=1) if S else torch.zeros_like(rf)
    return out.to(r.dtype), s


def rwkv6_scan_q8_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,  # (B, S, H, D)
    u: torch.Tensor,                                                    # (H, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 with r/k/v squeezed through per-row int8; the decay stays
    float.  -> (out in ``r.dtype``, final state f32)."""
    out, s = rwkv6_scan_ref(_q8_roundtrip(r), _q8_roundtrip(k), _q8_roundtrip(v),
                            w.float(), u)
    return out.to(r.dtype), s


def rglru_scan_q8_ref(
    a: torch.Tensor,               # (B, S, W) decay in (0, 1)
    x: torch.Tensor,               # (B, S, W) gated input
) -> torch.Tensor:
    """RG-LRU with the gated input squeezed through per-row int8 (rows of W)."""
    return rglru_scan_ref(a.float(), _q8_roundtrip(x)).to(x.dtype)
