"""Transformer layers (port of :mod:`repro.models.layers`): RMSNorm,
LayerNorm, RoPE and Qwen2-VL's M-RoPE, GQA attention (optional QKV bias) for
training, prefill (with the rotating window of the local-attention archs)
and KV-cache decode (native and int8 cache), encoder-decoder
cross-attention, the SwiGLU, GeGLU, GELU and squared-ReLU MLPs, linear,
embedding and logits.

Plain functions on tensors over the nested-dict parameter tree of
:mod:`repro_torch.models.param`, in the JAX layouts.  Attention goes
through :mod:`repro_torch.kernels.ops`, so it runs the CUDA kernels on the
card and their plain versions on the CPU.

The attention of training, prefill and decode, the MLPs, embedding and
logits take a :class:`~repro_torch.distributed.tensor.TensorPlan` (``tp``;
None on one device): under it a rank holds its ``model`` pieces of the
weights and computes its query heads (reading the KV heads of those heads),
FFN columns or vocabulary rows, with the collectives of
:mod:`repro_torch.distributed.tensor` around them.  Query heads the axis
does not divide are whole weights, of which a rank computes its block
(:func:`_rank_heads`).  A serving cache holds the rank's KV heads where the
axis divides them, else every KV head, each rank writing the whole new row
(the reference's replicated cache).  The reference's
``with_logical_constraint`` points are kept (``repro/models/layers.py``):
on a mesh they hold each activation's piece to its layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor
from repro_torch.distributed.sharding import with_logical_constraint as wlc
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as KR
from repro_torch.models.param import (
    ParamBuilder, normal_init, ones_init, scaled_init, zeros_init,
)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(b: ParamBuilder, name: str, dim: int):
    b.scope(name).param("scale", (dim,), ("norm",), init=ones_init())


def rms_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(b: ParamBuilder, name: str, dim: int):
    s = b.scope(name)
    s.param("scale", (dim,), ("norm",), init=ones_init())
    s.param("bias", (dim,), ("norm",), init=zeros_init())


def layer_norm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)               # (D/2,)
    angles = positions[..., None].float() * freqs               # (..., S, D/2)
    angles = angles[..., None, :]                               # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: Tuple[int, ...],
                theta: float = 1000000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE (``layers.py:103-135``).

    x: (B, S, H, D); positions: (3, B, S), the (temporal, height, width)
    position ids.  ``sections`` counts the frequency pairs of each stream
    (sum == D/2): pair i rotates by the position of the stream its section
    belongs to."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim/2 = {d // 2}")
    freqs = rope_freqs(d, theta, device=x.device)                # (D/2,)
    sec_ids = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                           device=x.device)                      # (D/2,)
    pos = positions.movedim(0, -1).float()                      # (B, S, 3)
    angles = pos[..., sec_ids][..., None, :] * freqs            # (B, S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rotate(q: torch.Tensor, k: torch.Tensor, positions, rope_theta: float, use_rope: bool,
            mrope_sections, mrope_positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k with M-RoPE (when ``mrope_sections`` is given), RoPE (when
    ``use_rope``), or as they are (whisper)."""
    if mrope_sections is not None:
        return (apply_mrope(q, mrope_positions, mrope_sections, rope_theta),
                apply_mrope(k, mrope_positions, mrope_sections, rope_theta))
    if use_rope:
        return apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta)
    return q, k


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------


def init_attention(b: ParamBuilder, name: str, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool = False):
    s = b.scope(name)
    s.param("wq", (d_model, n_heads, head_dim), ("embed", "heads", "head_dim"),
            init=scaled_init(0))
    s.param("wk", (d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"),
            init=scaled_init(0))
    s.param("wv", (d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"),
            init=scaled_init(0))
    s.param("wo", (n_heads, head_dim, d_model), ("heads", "head_dim", "embed"),
            init=scaled_init(0))
    if qkv_bias:
        s.param("bq", (n_heads, head_dim), ("heads", "head_dim"), init=zeros_init())
        s.param("bk", (n_kv_heads, head_dim), ("kv_heads", "head_dim"), init=zeros_init())
        s.param("bv", (n_kv_heads, head_dim), ("kv_heads", "head_dim"), init=zeros_init())


def q_project(p: Dict, x: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    return q + p["bq"].to(x.dtype) if "bq" in p else q


def qkv_project(p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    k, v = cross_kv(p, x)
    return q_project(p, x), k, v


def out_project(p: Dict, o: torch.Tensor, tp=None) -> torch.Tensor:
    """``o`` through ``wo``; under ``tp`` the rank's heads' partial sums,
    summed over the ``model`` group."""
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    if tp is not None and tp.heads:
        y = tensor.reduce_out(y, tp.axis)
    return wlc(y, "batch", "seq", "act_embed")


def _rank_heads(p: Dict, tp) -> Dict:
    """The attention's weights of the rank's query heads: ``p`` itself where
    the plan shards the heads (or runs on one device), else, under a padded
    split of whole weights, the rank's block of ``wq`` / ``bq`` / ``wo``,
    each copied in (its gradient holds the rank's heads' part, summed over
    the group)."""
    if tp is None or not tp.pad_heads:
        return p
    a, b = tp.head_block
    out = dict(p)
    for name, dim in (("wq", 1), ("bq", 0), ("wo", 0)):
        if name in p:
            out[name] = tensor.copy_in(p[name], tp.axis).narrow(dim, a, b - a)
    return out


def _tp_qkv(p: Dict, x: torch.Tensor, tp
            ) -> Tuple[Dict, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (the weights of a tensor-parallel rank's query heads,
    :func:`_rank_heads`; their q; its KV heads where the axis divides them,
    else every KV head computed whole).  Those K/V are what a serving cache
    holds; training then picks the ones its query heads read
    (:func:`_tp_kv`).  ``x`` is copied in for the rank's projections; whole
    K/V read ``x`` itself, their gradient summed by :func:`_tp_kv`'s
    copy-in."""
    ph = _rank_heads(p, tp)
    xq = tensor.copy_in(x, tp.axis)
    q = wlc(q_project(ph, xq), "batch", "seq", "act_heads", None)
    k, v = cross_kv(p, xq if tp.kv_heads else x)
    return (ph, q, wlc(k, "batch", "seq", "act_kv_heads", None),
            wlc(v, "batch", "seq", "act_kv_heads", None))


def _kv_of_heads(h_loc: int, tp):
    """The KV heads the rank's ``h_loc`` query heads (``tp.head_block``)
    read, of every KV head: a slice where they are whole groups or part of
    one, else a list of indices."""
    group = tp.n_heads // tp.n_kv_heads
    first = tp.head_block[0]
    lo = first // group
    hi = (first + h_loc - 1) // group + 1 if h_loc else lo
    if hi - lo <= 1 or (first % group == 0 and h_loc % group == 0):
        return slice(lo, hi)
    return [(first + i) // group for i in range(h_loc)]


def _pick_heads(t: torch.Tensor, sel) -> torch.Tensor:
    if isinstance(sel, slice):
        return t[:, :, sel]
    return t.index_select(2, torch.tensor(sel, device=t.device))


def _tp_kv(k: torch.Tensor, v: torch.Tensor, h_loc: int, tp
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V heads a rank's ``h_loc`` query heads read: ``k``, ``v`` as
    they are where they are the rank's KV heads, else (every KV head,
    computed whole) copied in and the rank's picked out."""
    k = wlc(k, "batch", "seq", "act_kv_heads", None)
    v = wlc(v, "batch", "seq", "act_kv_heads", None)
    if tp.kv_heads:
        return k, v
    sel = _kv_of_heads(h_loc, tp)
    return (_pick_heads(tensor.copy_in(k, tp.axis), sel),
            _pick_heads(tensor.copy_in(v, tp.axis), sel))


def _read_cache(leaves: Tuple[torch.Tensor, ...], h_loc: int, tp) -> Tuple[torch.Tensor, ...]:
    """A serving cache's leaves (B, T, Hkv, ·) as the rank's ``h_loc``
    query heads read them, contiguous for the kernels: as they are on one
    device or where they hold the rank's KV heads, else the KV heads of the
    rank's query heads picked out of every KV head."""
    if tp is None or tp.kv_heads:
        return leaves
    sel = _kv_of_heads(h_loc, tp)
    return tuple(_pick_heads(t, sel).contiguous() for t in leaves)


def attention_train(
    p: Dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    precision: str = "f32",
    tp=None,
) -> torch.Tensor:
    """Full-sequence attention of training (``layers.py:365-411``).

    ``precision`` is ``ModelConfig.train_precision``: ``"bf16"`` casts the
    attention operands before the kernel; ``"int8-fused"`` routes to the
    int8-K/V op, whose backward saves int8 residuals.  Positions rotate q and
    k by M-RoPE when ``mrope_sections`` is given, else by RoPE unless
    ``use_rope`` is False (whisper's learned and sinusoidal positions).
    Under ``tp`` the kernel runs at the rank's heads (any group size).
    """
    if tp is None:
        q, k, v = qkv_project(p, x)
    else:
        p, q, k, v = _tp_qkv(p, x, tp)
        k, v = _tp_kv(k, v, q.shape[2], tp)
    q, k = _rotate(q, k, positions, rope_theta, use_rope, mrope_sections, mrope_positions)
    if precision == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    attend = kops.flash_attention_q8 if precision == "int8-fused" else kops.flash_attention
    o = attend(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window)
    return out_project(p, o.to(x.dtype), tp)


def attention_prefill(
    p: Dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache_len: int,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    rotating: bool = False,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    kv_cache_dtype: str = "native",
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: full attention over the prompt AND its KV cache padded to
    ``cache_len``.  With ``kv_cache_dtype="int8"`` the cache holds per-row
    int8 K/V + f32 scales, but attention over the prompt itself runs on the
    full-precision K/V (as ``layers.py:448`` runs before ``:456``).

    ``rotating=True`` (the local-attention archs): the cache holds only the
    last ``min(S, cache_len)`` positions, aligned to slot 0, the layout the
    rotating-window decode expects; keys keep their absolute RoPE phases.
    Positions as in :func:`attention_train`.  Under ``tp`` the flash kernel
    runs at the rank's query heads and the cache holds the K/V that
    :func:`_tp_qkv` names."""
    p, q, k, v = (p, *qkv_project(p, x)) if tp is None else _tp_qkv(p, x, tp)
    q, k = _rotate(q, k, positions, rope_theta, use_rope, mrope_sections, mrope_positions)
    ka, va = _read_cache((k, v), q.shape[2], tp)
    o = kops.flash_attention(q.contiguous(), ka.contiguous(), va.contiguous(),
                             causal=causal, window=window)
    S = k.shape[1]
    if rotating and S > cache_len:
        k, v = k[:, S - cache_len:], v[:, S - cache_len:]
        S = cache_len
    if S > cache_len:
        raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
    pad = (0, 0, 0, 0, 0, cache_len - S)
    kc, vc = F.pad(k, pad), F.pad(v, pad)
    if kv_cache_dtype == "int8":
        # padded rows quantize against absmax 0 -> scale floor, q == 0
        kq, ks = KR.quantize_int8_ref(kc)
        vq, vs = KR.quantize_int8_ref(vc)
        cache = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    else:
        cache = {"k": kc, "v": vc}
    return out_project(p, o, tp), cache


def attention_decode(
    p: Dict,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    *,
    pos: torch.Tensor,                       # (B,) absolute position of the new token
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    slot: Optional[torch.Tensor] = None,     # (B,) cache row to write (default pos)
    valid_len: Optional[torch.Tensor] = None,  # (B,) live cache rows (default slot+1)
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a KV cache. x: (B, 1, d).

    The new K/V row of batch row ``b`` is written IN PLACE at ``cache[...][b,
    slot[b]]`` (the JAX package writes it with a vmapped
    ``dynamic_update_slice`` into a donated buffer); the returned dict holds
    the same tensors.  Rows ``< valid_len[b]`` attend.  An int8 cache
    (``"k_scale"`` leaf) quantizes the new row before the write and attends
    through the int8 decode op.  RoPE rotates at ``pos`` (which a VLM
    shifts by its M-RoPE offset; the write stays at ``slot``), unless
    ``use_rope`` is False.  Under ``tp`` the rank's query heads attend
    over the cache's KV heads of theirs (:func:`_read_cache`).
    """
    # (B,1,H,D) / (B,1,Hkv,D)
    p, q, k, v = (p, *qkv_project(p, x)) if tp is None else _tp_qkv(p, x, tp)
    if use_rope:
        q = apply_rope(q, pos[:, None], rope_theta)
        k = apply_rope(k, pos[:, None], rope_theta)
    idx = (pos if slot is None else slot).long()      # (B,) write row
    valid = (idx + 1 if valid_len is None else valid_len).to(torch.int32)
    rows = torch.arange(x.shape[0], device=x.device)
    q = q.contiguous()

    if "k_scale" in cache:
        kq, ks_new = KR.quantize_int8_ref(k)
        vq, vs_new = KR.quantize_int8_ref(v)
        cache["k"][rows, idx] = kq[:, 0]
        cache["k_scale"][rows, idx] = ks_new[:, 0]
        cache["v"][rows, idx] = vq[:, 0]
        cache["v_scale"][rows, idx] = vs_new[:, 0]
        o = kops.decode_attention_int8(
            q, *_read_cache((cache["k"], cache["k_scale"], cache["v"], cache["v_scale"]),
                            q.shape[2], tp), valid, window=window)
        return out_project(p, o, tp), cache

    cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
    o = kops.decode_attention(q, *_read_cache((cache["k"], cache["v"]), q.shape[2], tp),
                              valid, window=window)
    return out_project(p, o, tp), cache


def cross_kv(p: Dict, ctx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V of ``ctx`` (B, S, d) through the layer's ``wk``/``wv`` (and biases)."""
    k = torch.einsum("bsd,dhk->bshk", ctx, p["wk"].to(ctx.dtype))
    v = torch.einsum("bsd,dhk->bshk", ctx, p["wv"].to(ctx.dtype))
    if "bk" in p:
        k = k + p["bk"].to(ctx.dtype)
        v = v + p["bv"].to(ctx.dtype)
    return k, v


def cross_attention(p: Dict, x: torch.Tensor, ctx_k: torch.Tensor,
                    ctx_v: torch.Tensor, tp=None) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V, no RoPE, no
    mask (``layers.py:569-585``): every query row sees every frame, through
    the flash op with ``causal=False`` (Sq decoder rows against Skv frames).

    Under ``tp`` the rank's query heads read the rank's K/V heads:
    ``ctx_k`` / ``ctx_v`` are those where the axis divides the KV heads
    (:func:`cross_kv` of the rank's ``wk`` / ``wv`` over the copied-in
    encoder output), else every KV head, of which the rank's are picked."""
    p = _rank_heads(p, tp)
    xq = x if tp is None else tensor.copy_in(x, tp.axis)
    q = wlc(q_project(p, xq), "batch", "seq", "act_heads", None)
    if tp is not None:
        ctx_k, ctx_v = _tp_kv(ctx_k, ctx_v, q.shape[2], tp)
    o = kops.flash_attention(q.contiguous(), ctx_k.contiguous(), ctx_v.contiguous(),
                             causal=False)
    return out_project(p, o, tp)


def cross_attention_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                           tp=None) -> torch.Tensor:
    """One decoder row (B, 1, d) against the cached cross K/V (``"xk"``,
    ``"xv"``, and with an int8 cache ``"xk_scale"``, ``"xv_scale"``) through
    the decode op, every frame valid: the same unmasked attention as
    :func:`cross_attention` (reference ``encdec.py:250-262``).  The int8
    cache is attended in place, dequantized inside the kernel (the
    reference dequantizes first, then attends).  Under ``tp`` the rank's
    query heads over the cache's KV heads of theirs."""
    p = _rank_heads(p, tp)
    q = wlc(q_project(p, x), "batch", "seq", "act_heads", None).contiguous()
    xk = cache["xk"]
    valid = torch.full((x.shape[0],), xk.shape[1], dtype=torch.int32, device=x.device)
    if "xk_scale" in cache:
        o = kops.decode_attention_int8(
            q, *_read_cache((xk, cache["xk_scale"], cache["xv"], cache["xv_scale"]),
                            q.shape[2], tp), valid)
    else:
        o = kops.decode_attention(q, *_read_cache((xk, cache["xv"]), q.shape[2], tp), valid)
    return out_project(p, o, tp)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(b: ParamBuilder, name: str, d_model: int, d_ff: int):
    s = b.scope(name)
    s.param("wi_gate", (d_model, d_ff), ("embed", "mlp"), init=scaled_init(0))
    s.param("wi_up", (d_model, d_ff), ("embed", "mlp"), init=scaled_init(0))
    s.param("wo", (d_ff, d_model), ("mlp", "embed"), init=scaled_init(0))


def _column_in(x: torch.Tensor, tp) -> torch.Tensor:
    """An MLP's input: copied in where the rank holds FFN columns."""
    return tensor.copy_in(x, tp.axis) if tp is not None and tp.mlp else x


def _row_out(y: torch.Tensor, tp) -> torch.Tensor:
    """An MLP's output: its columns' partial sums summed over the group."""
    return tensor.reduce_out(y, tp.axis) if tp is not None and tp.mlp else y


def swiglu(p: Dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    x = _column_in(x, tp)
    g = torch.matmul(x, p["wi_gate"].to(x.dtype))
    u = torch.matmul(x, p["wi_up"].to(x.dtype))
    h = wlc(F.silu(g) * u, "batch", "seq", "act_mlp")
    return wlc(_row_out(torch.matmul(h, p["wo"].to(x.dtype)), tp), "batch", "seq", "act_embed")


def init_geglu(b: ParamBuilder, name: str, d_model: int, d_ff: int):
    init_swiglu(b, name, d_model, d_ff)


def geglu(p: Dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """GELU-gated MLP; the GELU is ``jax.nn.gelu``'s default, the tanh
    approximation."""
    x = _column_in(x, tp)
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"].to(x.dtype))
    h = wlc(F.gelu(g, approximate="tanh") * u, "batch", "seq", "act_mlp")
    y = torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))
    return wlc(_row_out(y, tp), "batch", "seq", "act_embed")


def init_gelu_mlp(b: ParamBuilder, name: str, d_model: int, d_ff: int, bias: bool = True):
    s = b.scope(name)
    s.param("wi", (d_model, d_ff), ("embed", "mlp"), init=scaled_init(0))
    s.param("wo", (d_ff, d_model), ("mlp", "embed"), init=scaled_init(0))
    if bias:
        s.param("bi", (d_ff,), ("mlp",), init=zeros_init())
        s.param("bo", (d_model,), ("embed",), init=zeros_init())


def _two_layer(p: Dict, x: torch.Tensor, act, tp=None) -> torch.Tensor:
    """``act(x wi + bi) wo + bo``, the biases where the tree holds them
    (``bo``, whole on every rank, after the partial sums are summed)."""
    x = _column_in(x, tp)
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    if "bi" in p:
        h = h + p["bi"].to(x.dtype)
    h = wlc(h, "batch", "seq", "act_mlp")
    y = _row_out(torch.einsum("bsf,fd->bsd", act(h), p["wo"].to(x.dtype)), tp)
    if "bo" in p:
        y = y + p["bo"].to(x.dtype)
    return wlc(y, "batch", "seq", "act_embed")


def gelu_mlp(p: Dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Whisper's MLP: GELU in ``jax.nn.gelu``'s default, tanh form."""
    return _two_layer(p, x, lambda h: F.gelu(h, approximate="tanh"), tp)


def relu2_mlp(p: Dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Nemotron's squared-ReLU MLP (no biases)."""
    return _two_layer(p, x, lambda h: torch.square(F.relu(h)), tp)


def init_mlp(b: ParamBuilder, name: str, kind: str, d_model: int, d_ff: int):
    """kind: swiglu | geglu | gelu | relu2 (``layers.py:614-620``)."""
    if kind in ("swiglu", "geglu"):
        init_swiglu(b, name, d_model, d_ff)
    elif kind in ("gelu", "relu2"):
        init_gelu_mlp(b, name, d_model, d_ff, bias=(kind == "gelu"))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")


_MLPS = {"swiglu": swiglu, "geglu": geglu, "gelu": gelu_mlp, "relu2": relu2_mlp}


def mlp_apply(p: Dict, x: torch.Tensor, kind: str, tp=None) -> torch.Tensor:
    return _MLPS[kind](p, x, tp)


def init_linear(b: ParamBuilder, name: str, d_in: int, d_out: int,
                axes: Tuple[Optional[str], Optional[str]] = ("embed", "mlp"),
                bias: bool = False):
    s = b.scope(name)
    s.param("w", (d_in, d_out), axes, init=scaled_init(0))
    if bias:
        s.param("b", (d_out,), (axes[1],), init=zeros_init())


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def init_embedding(b: ParamBuilder, name: str, vocab: int, d_model: int):
    b.scope(name).param("table", (vocab, d_model), ("vocab", "embed"), init=normal_init(1.0))


def embed(p: Dict, tokens: torch.Tensor, dtype: torch.dtype = torch.float32,
          tp=None) -> torch.Tensor:
    """Token rows; under ``tp`` over vocabulary shards
    (:func:`repro_torch.distributed.tensor.embed`)."""
    if tp is not None and tp.vocab:
        x = tensor.embed(p["table"], tokens, dtype, tp.axis)
    else:
        x = p["table"].to(dtype)[tokens]
    return wlc(x, "batch", "seq", "act_embed")


def logits(p: Dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits; under ``tp`` the rank's vocabulary columns (B, S, V/m)."""
    if tp is not None and tp.vocab:
        x = tensor.copy_in(x, tp.axis)
    y = torch.einsum("bsd,vd->bsv", x, p["table"].to(x.dtype))
    return wlc(y, "batch", "seq", "act_vocab")
