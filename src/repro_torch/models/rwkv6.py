"""RWKV-6 "Finch" (arXiv:2404.05892), port of :mod:`repro.models.rwkv6`:
attention-free LM with data-dependent decay and a matrix-valued state per
head.

Per layer, time mixing carries S in R^{H x D x D}:

    w_t   = exp(-exp(w0 + tanh(x_t A_w) B_w))          (data-dependent decay)
    out_t = r_t . (S_{t-1} + (u k_t^T) v_t)            (bonus u for the current token)
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t

then a head-wise group norm and a SiLU(g) gate; channel mixing is the
squared-ReLU MLP.  Both mix each input with the previous token's (token shift).

Entry points:
  * ``init_params(cfg, seed=..., device=...)``         -> (params, logical_axes)
  * ``forward(params, cfg, tokens)``                   -> logits (train)
  * ``init_cache(cfg, batch, cache_len, device=...)``  -> zeroed O(1) state
  * ``prefill(params, cfg, tokens, cache_len)``        -> (last logits, state)
  * ``decode_step(params, cfg, token, cache, pos)``    -> (logits, state)

``forward`` and ``prefill`` run the WKV recurrence through
:func:`repro_torch.kernels.ops.rwkv6_scan`, or under
``train_precision="int8-fused"`` through
:func:`~repro_torch.kernels.ops.rwkv6_scan_q8` (the CUDA kernels on the card);
``decode_step`` through the plain one-token step, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.dense import _layer, _scan_blocks
from repro_torch.models.param import (
    ParamBuilder, build, normal_init, ones_init, scaled_init, stacked, zeros_init,
)

PyTree = Any


# ---------------------------------------------------------------------------
# WKV6 recurrence, one token
# ---------------------------------------------------------------------------


def wkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. r/k/v/w: (B, H, D); s: (B, H, D, D) -> (out, new s f32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    sf = s.float()
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhd,bhde->bhe", rf, sf + u[..., :, None] * kv)
    s_new = wf[..., :, None] * sf + kv
    return out.to(r.dtype), s_new


# ---------------------------------------------------------------------------
# Time mixing
# ---------------------------------------------------------------------------


def init_time_mix(b, cfg: ModelConfig):
    d = cfg.d_model
    la = cfg.decay_lora
    s = b.scope("tmix")
    for nm in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        s.param(nm, (d,), ("lru",), init=normal_init(0.02))
    for nm in ("wr", "wk", "wv", "wg"):
        s.param(nm, (d, d), ("embed", "lru"), init=scaled_init(0))
    s.param("wo", (d, d), ("lru", "embed"), init=scaled_init(0))
    # data-dependent decay LoRA
    s.param("w0", (d,), ("lru",), init=normal_init(0.5))
    s.param("wa", (d, la), ("embed", None), init=scaled_init(0))
    s.param("wb", (la, d), (None, "lru"), init=zeros_init())
    # per-head bonus
    s.param("u", (d,), ("lru",), init=normal_init(0.5))
    # head-wise group norm
    s.param("gn_scale", (d,), ("lru",), init=ones_init())
    s.param("gn_bias", (d,), ("lru",), init=zeros_init())


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1}; the first token takes ``x_prev`` (decode) or zeros (prefill)."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mixer(x: torch.Tensor, xp: torch.Tensor):
    def mix(mu):
        return x + (xp - x) * torch.sigmoid(mu.to(x.dtype))

    return mix


def _group_norm(p: Dict, x: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Head-wise group norm over (B, S, H, D), flattened back to channels."""
    B, S, H, D = x.shape
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, S, H * D)
    return (y * p["gn_scale"].float() + p["gn_bias"].float()).to(x.dtype)


def time_mix(p: Dict, x: torch.Tensor, cfg: ModelConfig,
             state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d).  ``state`` None: the whole prompt through the scan op;
    otherwise one decode token against ``{"shift": (B, d), "wkv": (B, H, D, D)}``.
    Returns (out, {"shift": x[:, -1], "wkv": state after the last position})."""
    hd = cfg.rwkv_head_dim
    B, S, d = x.shape
    H = d // hd
    mix = _mixer(x, _token_shift(x, state["shift"] if state else None))

    r = mix(p["mu_r"]) @ p["wr"].to(x.dtype)
    k = mix(p["mu_k"]) @ p["wk"].to(x.dtype)
    v = mix(p["mu_v"]) @ p["wv"].to(x.dtype)
    g = mix(p["mu_g"]) @ p["wg"].to(x.dtype)
    decay_in = torch.tanh(mix(p["mu_w"]) @ p["wa"].to(x.dtype)) @ p["wb"].to(x.dtype)
    w = torch.exp(-torch.exp(torch.clamp(p["w0"].float() + decay_in.float(), -10.0, 5.0)))

    # the decay goes to the scan in the model dtype (rwkv6.py:156)
    r4, k4, v4, w4 = (t.reshape(B, S, H, hd) for t in (r, k, v, w.to(x.dtype)))
    u = p["u"].float().reshape(H, hd)
    if state is None:
        if cfg.train_precision == "bf16":
            r4, k4, v4 = (t.to(torch.bfloat16) for t in (r4, k4, v4))
        # int8-fused: r/k/v stream as int8 + row scales, the decay stays float
        scan = kops.rwkv6_scan_q8 if cfg.train_precision == "int8-fused" else kops.rwkv6_scan
        out, s_new = scan(r4.contiguous(), k4.contiguous(), v4.contiguous(),
                          w4.contiguous(), u)
    else:
        out, s_new = wkv6_step(r4[:, 0], k4[:, 0], v4[:, 0], w4[:, 0], u, state["wkv"])
        out = out[:, None]

    out = _group_norm(p, out) * F.silu(g)
    return out @ p["wo"].to(x.dtype), {"shift": x[:, -1], "wkv": s_new}


# ---------------------------------------------------------------------------
# Channel mixing
# ---------------------------------------------------------------------------


def init_channel_mix(b, cfg: ModelConfig):
    s = b.scope("cmix")
    s.param("mu_r", (cfg.d_model,), ("lru",), init=normal_init(0.02))
    s.param("mu_k", (cfg.d_model,), ("lru",), init=normal_init(0.02))
    s.param("wr", (cfg.d_model, cfg.d_model), ("embed", "lru"), init=scaled_init(0))
    s.param("wk", (cfg.d_model, cfg.d_ff), ("embed", "mlp"), init=scaled_init(0))
    s.param("wv", (cfg.d_ff, cfg.d_model), ("mlp", "embed"), init=scaled_init(0))


def channel_mix(p: Dict, x: torch.Tensor, shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    mix = _mixer(x, _token_shift(x, shift))
    r = torch.sigmoid(mix(p["mu_r"]) @ p["wr"].to(x.dtype))
    k = torch.square(torch.relu(mix(p["mu_k"]) @ p["wk"].to(x.dtype)))
    return r * (k @ p["wv"].to(x.dtype))


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _init_block(s, cfg: ModelConfig):
    L.init_layernorm(s, "ln1", cfg.d_model)
    init_time_mix(s, cfg)
    L.init_layernorm(s, "ln2", cfg.d_model)
    init_channel_mix(s, cfg)


def init_params(
    cfg: ModelConfig,
    *,
    seed: Optional[int] = None,
    abstract: bool = False,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = "cuda",
) -> Tuple[PyTree, PyTree]:
    dev = torch.device("meta") if abstract else resolve_device(device)

    def f(b: ParamBuilder):
        L.init_embedding(b, "embedding", cfg.vocab, cfg.d_model)
        L.init_layernorm(b, "ln0", cfg.d_model)
        _init_block(stacked(b, cfg.n_layers).scope("blocks"), cfg)
        L.init_layernorm(b, "ln_f", cfg.d_model)
        if not cfg.tie_embeddings:
            L.init_embedding(b, "lm_head", cfg.vocab, cfg.d_model)

    return build(f, seed=seed, abstract=abstract, dtype=dtype or cfg.dtype, device=dev)


def _logits(params: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.layer_norm(params["ln_f"], x)
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    return L.logits(head, x)


def _block_train(lp: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h, _ = time_mix(lp["tmix"], L.layer_norm(lp["ln1"], x), cfg)
    x = x + h
    return x + channel_mix(lp["cmix"], L.layer_norm(lp["ln2"], x))


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Training forward. tokens: (B, S) int -> logits (B, S, V)."""
    x = L.embed(params["embedding"], tokens, cfg.dtype)
    x = L.layer_norm(params["ln0"], x)
    x = _scan_blocks(params, x, cfg, lambda lp, h: _block_train(lp, h, cfg))
    return _logits(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int = 0, dtype=None,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The O(1) recurrent state (``cache_len`` is unused)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    Ln = cfg.n_layers
    return {
        "tshift": torch.zeros((Ln, batch, cfg.d_model), dtype=dtype, device=dev),
        "cshift": torch.zeros((Ln, batch, cfg.d_model), dtype=dtype, device=dev),
        "wkv": torch.zeros((Ln, batch, H, hd, hd), dtype=torch.float32, device=dev),
    }


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt; return (last-position logits (B, 1, V), decode-ready state)."""
    x = L.embed(params["embedding"], tokens, cfg.dtype)
    x = L.layer_norm(params["ln0"], x)
    tshift, cshift, wkv = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        t_out, st = time_mix(lp["tmix"], L.layer_norm(lp["ln1"], x), cfg)
        tshift.append(st["shift"])
        wkv.append(st["wkv"])
        x = x + t_out
        xn = L.layer_norm(lp["ln2"], x)
        cshift.append(xn[:, -1])
        x = x + channel_mix(lp["cmix"], xn)
    cache = {"tshift": torch.stack(tshift), "cshift": torch.stack(cshift),
             "wkv": torch.stack(wkv)}
    return _logits(params, cfg, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token (B, 1) -> logits (B, 1, V).  ``cache`` is updated in place (the
    JAX package donates it) and returned; ``pos`` is unused (O(1) state)."""
    x = L.embed(params["embedding"], token, cfg.dtype)
    x = L.layer_norm(params["ln0"], x)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        xn = L.layer_norm(lp["ln1"], x)
        t_out, st = time_mix(lp["tmix"], xn, cfg,
                             state={"shift": cache["tshift"][i], "wkv": cache["wkv"][i]})
        x = x + t_out
        xn = L.layer_norm(lp["ln2"], x)
        c_out = channel_mix(lp["cmix"], xn, cache["cshift"][i])
        x = x + c_out
        cache["tshift"][i] = st["shift"]
        cache["wkv"][i] = st["wkv"]
        cache["cshift"][i] = xn[:, -1]
    return _logits(params, cfg, x), cache
