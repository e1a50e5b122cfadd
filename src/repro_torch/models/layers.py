"""Transformer layers (port of a subset of :mod:`repro.models.layers`):
RMSNorm, LayerNorm, RoPE, GQA attention for training, prefill (with the
rotating window of the local-attention archs) and KV-cache decode (native
and int8 cache), SwiGLU, GeGLU, linear, embedding and logits.

Plain functions on tensors over the nested-dict parameter tree of
:mod:`repro_torch.models.param`, in the JAX layouts.  The JAX package's
``with_logical_constraint`` annotations have no counterpart: this slice runs
on one device.  Attention goes through :mod:`repro_torch.kernels.ops`, so it
runs the CUDA kernels on the card and their plain versions on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------


def init_attention(b: ParamBuilder, name: str, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int):
    s = b.scope(name)
    s.param("wq", (d_model, n_heads, head_dim), ("embed", "heads", "head_dim"),
            init=scaled_init(0))
    s.param("wk", (d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"),
            init=scaled_init(0))
    s.param("wv", (d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"),
            init=scaled_init(0))
    s.param("wo", (n_heads, head_dim, d_model), ("heads", "head_dim", "embed"),
            init=scaled_init(0))


def qkv_project(p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    return q, k, v


def out_project(p: Dict, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def attention_train(
    p: Dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    precision: str = "f32",
) -> torch.Tensor:
    """Full-sequence attention of training (``layers.py:365-411``).

    ``precision`` is ``ModelConfig.train_precision``: ``"bf16"`` casts the
    attention operands before the kernel; ``"int8-fused"`` routes to the
    int8-K/V op, whose backward saves int8 residuals.
    """
    q, k, v = qkv_project(p, x)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if precision == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    attend = kops.flash_attention_q8 if precision == "int8-fused" else kops.flash_attention
    o = attend(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window)
    return out_project(p, o.to(x.dtype))


def attention_prefill(
    p: Dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache_len: int,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    rotating: bool = False,
    kv_cache_dtype: str = "native",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: full attention over the prompt AND its KV cache padded to
    ``cache_len``.  With ``kv_cache_dtype="int8"`` the cache holds per-row
    int8 K/V + f32 scales, but attention over the prompt itself runs on the
    full-precision K/V (as ``layers.py:448`` runs before ``:456``).

    ``rotating=True`` (the local-attention archs): the cache holds only the
    last ``min(S, cache_len)`` positions, aligned to slot 0, the layout the
    rotating-window decode expects; keys keep their absolute RoPE phases."""
    q, k, v = qkv_project(p, x)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    o = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
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
    return out_project(p, o), cache


def attention_decode(
    p: Dict,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    *,
    pos: torch.Tensor,                       # (B,) absolute position of the new token
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    slot: Optional[torch.Tensor] = None,     # (B,) cache row to write (default pos)
    valid_len: Optional[torch.Tensor] = None,  # (B,) live cache rows (default slot+1)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a KV cache. x: (B, 1, d).

    The new K/V row of batch row ``b`` is written IN PLACE at ``cache[...][b,
    slot[b]]`` (the JAX package writes it with a vmapped
    ``dynamic_update_slice`` into a donated buffer); the returned dict holds
    the same tensors.  Rows ``< valid_len[b]`` attend.  An int8 cache
    (``"k_scale"`` leaf) quantizes the new row before the write and attends
    through the int8 decode op.
    """
    q, k, v = qkv_project(p, x)                       # (B,1,H,D) / (B,1,Hkv,D)
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
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], valid,
            window=window)
        return out_project(p, o), cache

    cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
    o = kops.decode_attention(q, cache["k"], cache["v"], valid, window=window)
    return out_project(p, o), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(b: ParamBuilder, name: str, d_model: int, d_ff: int):
    s = b.scope(name)
    s.param("wi_gate", (d_model, d_ff), ("embed", "mlp"), init=scaled_init(0))
    s.param("wi_up", (d_model, d_ff), ("embed", "mlp"), init=scaled_init(0))
    s.param("wo", (d_ff, d_model), ("mlp", "embed"), init=scaled_init(0))


def swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, p["wi_gate"].to(x.dtype))
    u = torch.matmul(x, p["wi_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, p["wo"].to(x.dtype))


def init_geglu(b: ParamBuilder, name: str, d_model: int, d_ff: int):
    init_swiglu(b, name, d_model, d_ff)


def geglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """GELU-gated MLP; the GELU is ``jax.nn.gelu``'s default, the tanh
    approximation."""
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"].to(x.dtype))
    h = F.gelu(g, approximate="tanh") * u
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))


def init_mlp(b: ParamBuilder, name: str, kind: str, d_model: int, d_ff: int):
    if kind != "swiglu":
        raise NotImplementedError(f"mlp {kind!r} is not ported yet (ROADMAP: model families)")
    init_swiglu(b, name, d_model, d_ff)


def mlp_apply(p: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(f"mlp {kind!r} is not ported yet (ROADMAP: model families)")
    return swiglu(p, x)


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


def embed(p: Dict, tokens: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return p["table"].to(dtype)[tokens]


def logits(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,vd->bsv", x, p["table"].to(x.dtype))
