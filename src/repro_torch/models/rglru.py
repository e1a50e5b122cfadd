"""RecurrentGemma / Griffin-style hybrid (arXiv:2402.19427), port of
:mod:`repro.models.rglru`: RG-LRU recurrent blocks and local attention in a
repeating (R, R, A) pattern.

RG-LRU recurrence (per channel, c = 8):
    r_t = sigmoid(x_t W_a + b_a)                      (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)                      (input gate)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = exp(log a_t) * h_{t-1} + sqrt(1 - exp(2 log a_t)) * (i_t * x_t)

The recurrent block is linear-in (two branches) -> [causal conv1d(4) ->
RG-LRU] * gelu-gate -> linear-out; each layer is that block (or local
attention) plus a GeGLU MLP, both pre-norm residual.

Entry points as :mod:`repro_torch.models.dense`.  ``forward`` and
``prefill`` run the RG-LRU through :func:`repro_torch.kernels.ops.rglru_scan`
(or, under ``train_precision="int8-fused"``,
:func:`~repro_torch.kernels.ops.rglru_scan_q8`) and the A layers through the
flash attention ops; ``decode_step`` steps the recurrence in plain PyTorch and
attends through the decode op over each A layer's rotating window.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.dense import _final, _layer, _run_layer
from repro_torch.models.param import (
    ParamBuilder, build, normal_init, stacked, uniform_init, zeros_init,
)

PyTree = Any
C_RGLRU = 8.0


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------


def init_rglru(b, name: str, width: int):
    s = b.scope(name)
    s.param("wa", (width,), ("lru",), init=zeros_init())       # diagonal gates
    s.param("ba", (width,), ("lru",), init=zeros_init())
    s.param("wx", (width,), ("lru",), init=zeros_init())
    s.param("bx", (width,), ("lru",), init=zeros_init())
    # Lambda init so that a = sigmoid(Lambda) in [0.9, 0.999] (paper init)
    s.param("lam", (width,), ("lru",), init=uniform_init(2.2, 6.9))


def _rglru_gates(p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, W) -> (log_a, gated_x) both (B, S, W), float32."""
    xf = x.float()
    r = torch.sigmoid(xf * p["wa"].float() + p["ba"].float())
    i = torch.sigmoid(xf * p["wx"].float() + p["bx"].float())
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))      # jax.nn.softplus
    log_a = -C_RGLRU * softplus * r
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)
    return log_a, gated


def rglru_scan(p: Dict, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The whole sequence through the scan op. x: (B, S, W) -> y (B, S, W) in x.dtype."""
    log_a, gated = _rglru_gates(p, x)
    a = torch.exp(log_a)
    if precision == "int8-fused":
        # the gated input streams as int8 + row scales; the decay stays f32
        return kops.rglru_scan_q8(a, gated).to(x.dtype)
    if precision == "bf16":
        gated = gated.to(torch.bfloat16).float()
    return kops.rglru_scan(a, gated).to(x.dtype)


def rglru_step(p: Dict, x: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x: (B, 1, W), h: (B, W) -> (y, new h f32)."""
    log_a, gated = _rglru_gates(p, x)
    new_h = torch.exp(log_a[:, 0]) * h.float() + gated[:, 0]
    return new_h[:, None].to(x.dtype), new_h


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (width 4)
# ---------------------------------------------------------------------------


def init_conv1d(b, name: str, width: int, ksize: int):
    s = b.scope(name)
    s.param("w", (ksize, width), ("conv", "lru"), init=normal_init(0.02))
    s.param("b", (width,), ("lru",), init=zeros_init())


def causal_conv1d(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in the model dtype. x: (B, S, W)."""
    k, S = p["w"].shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:S] * p["w"][0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + S] * p["w"][i].to(x.dtype)
    return out + p["b"].to(x.dtype)


def conv1d_step(p: Dict, x: torch.Tensor, window: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode step, in float32. x: (B, 1, W); window: (B, k-1, W) past inputs."""
    full = torch.cat([window, x], dim=1)                         # (B, k, W)
    out = torch.einsum("bkw,kw->bw", full.float(), p["w"].float())[:, None]
    return out.to(x.dtype) + p["b"].to(x.dtype), full[:, 1:]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def init_recurrent_block(s, cfg: ModelConfig):
    w = cfg.lru_width or cfg.d_model
    L.init_linear(s, "in_rec", cfg.d_model, w, axes=("embed", "lru"))
    L.init_linear(s, "in_gate", cfg.d_model, w, axes=("embed", "lru"))
    init_conv1d(s, "conv", w, cfg.conv_width)
    init_rglru(s, "lru", w)
    L.init_linear(s, "out", w, cfg.d_model, axes=("lru", "embed"))


def recurrent_block(lp: Dict, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The prompt through the block -> (out, decode-ready {"conv", "lru"})."""
    rec_in = L.linear(lp["in_rec"], x)
    gate = F.gelu(L.linear(lp["in_gate"], x), approximate="tanh")
    rec = rglru_scan(lp["lru"], causal_conv1d(lp["conv"], rec_in), cfg.train_precision)
    out = L.linear(lp["out"], rec * gate)
    # conv window: the last (k-1) conv INPUTS, zero-padded on the left when
    # the prompt is shorter; lru h: the last scan output, after its cast to
    # the model dtype (rglru.py:169)
    k, S = lp["conv"]["w"].shape[0], rec_in.shape[1]
    win = rec_in[:, max(0, S - (k - 1)):]
    if S < k - 1:
        win = F.pad(win, (0, 0, k - 1 - S, 0))
    return out, {"conv": win, "lru": rec[:, -1].float()}


def recurrent_block_step(lp: Dict, x: torch.Tensor, state: Dict
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    rec = L.linear(lp["in_rec"], x)
    gate = F.gelu(L.linear(lp["in_gate"], x), approximate="tanh")
    rec, conv_win = conv1d_step(lp["conv"], rec, state["conv"])
    rec, h = rglru_step(lp["lru"], rec, state["lru"])
    return L.linear(lp["out"], rec * gate), {"conv": conv_win, "lru": h}


def _init_layer(s, cfg: ModelConfig, kind: str):
    L.init_rmsnorm(s, "ln1", cfg.d_model)
    if kind == "A":
        L.init_attention(s, "attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim())
    else:
        init_recurrent_block(s, cfg)
    L.init_rmsnorm(s, "ln2", cfg.d_model)
    L.init_geglu(s, "mlp", cfg.d_model, cfg.d_ff)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.block_pattern or ("R", "R", "A")
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def init_params(
    cfg: ModelConfig,
    *,
    seed: Optional[int] = None,
    abstract: bool = False,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = "cuda",
) -> Tuple[PyTree, PyTree]:
    """Layers are stacked per kind: ``groups`` holds {"R": recurrent layers,
    "A": attention layers}; execution interleaves them by the pattern."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    kinds = layer_kinds(cfg)
    n_r = kinds.count("R")
    n_a = len(kinds) - n_r

    def f(b: ParamBuilder):
        L.init_embedding(b, "embedding", cfg.vocab, cfg.d_model)
        g = b.scope("groups")
        if n_r:
            _init_layer(stacked(g, n_r).scope("R"), cfg, "R")
        if n_a:
            _init_layer(stacked(g, n_a).scope("A"), cfg, "A")
        L.init_rmsnorm(b, "ln_f", cfg.d_model)
        if not cfg.tie_embeddings:
            L.init_embedding(b, "lm_head", cfg.vocab, cfg.d_model)

    return build(f, seed=seed, abstract=abstract, dtype=dtype or cfg.dtype, device=dev)


def _layer_train(lp: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 positions: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(lp["ln1"], x)
    if kind == "A":
        h = L.attention_train(
            lp["attn"], h, positions=positions, causal=True, window=cfg.window,
            rope_theta=cfg.rope_theta, precision=cfg.train_precision)
    else:
        h, _ = recurrent_block(lp, h, cfg)
    x = x + h
    return x + L.geglu(lp["mlp"], L.rms_norm(lp["ln2"], x))


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Training forward. tokens: (B, S) int -> logits (B, S, V).  The layers
    run in pattern order, each a view of its kind's stacked group."""
    x = L.embed(params["embedding"], tokens, cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    idx = {"R": 0, "A": 0}
    for kind in layer_kinds(cfg):
        x = _run_layer(cfg, lambda lp, h, kind=kind: _layer_train(lp, h, cfg, kind, positions),
                       _layer(params["groups"][kind], idx[kind]), x)
        idx[kind] += 1
    return _final(params, x, cfg)


def _attn_len(cfg: ModelConfig, cache_len: int) -> int:
    return min(cache_len, cfg.window or cache_len)


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
    """Run the prompt; return (last-position logits, decode-ready cache).

    A-layer caches are rotating windows of ``min(window, cache_len)`` rows
    holding the last in-window K/V (absolute RoPE phases); R-layer states are
    (conv window, final lru h)."""
    x = L.embed(params["embedding"], tokens, cfg.dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    a_kv, r_conv, r_lru = [], [], []
    idx = {"R": 0, "A": 0}
    for kind in layer_kinds(cfg):
        lp = _layer(params["groups"][kind], idx[kind])
        h = L.rms_norm(lp["ln1"], x)
        if kind == "A":
            h, kv = L.attention_prefill(
                lp["attn"], h, positions=positions, cache_len=_attn_len(cfg, cache_len),
                causal=True, window=cfg.window, rope_theta=cfg.rope_theta,
                rotating=True, kv_cache_dtype=cfg.kv_cache_dtype)
            a_kv.append(kv)
        else:
            h, st = recurrent_block(lp, h, cfg)
            r_conv.append(st["conv"])
            r_lru.append(st["lru"])
        x = x + h
        x = x + L.geglu(lp["mlp"], L.rms_norm(lp["ln2"], x))
        idx[kind] += 1
    empty = torch.zeros((0,), device=x.device)
    cache = {
        "A": ({n: torch.stack([kv[n] for kv in a_kv]) for n in a_kv[0]} if a_kv else
              {n: empty for n in _kv_leaves(cfg)}),
        "R": ({"conv": torch.stack(r_conv), "lru": torch.stack(r_lru)} if r_conv else
              {"conv": empty, "lru": empty}),
    }
    return _final(params, x[:, -1:], cfg), cache


def _kv_leaves(cfg: ModelConfig) -> Tuple[str, ...]:
    return ("k", "k_scale", "v", "v_scale") if cfg.kv_cache_dtype == "int8" else ("k", "v")


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device: DeviceLike = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    kinds = layer_kinds(cfg)
    n_r = kinds.count("R")
    n_a = len(kinds) - n_r
    w = cfg.lru_width or cfg.d_model
    kv_shape = (n_a, batch, _attn_len(cfg, cache_len), cfg.n_kv_heads, cfg.resolved_head_dim())
    if cfg.kv_cache_dtype == "int8":
        sshape = kv_shape[:-1] + (1,)
        a_cache = {
            "k": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
            "v": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
        }
    else:
        a_cache = {"k": torch.zeros(kv_shape, dtype=dtype, device=dev),
                   "v": torch.zeros(kv_shape, dtype=dtype, device=dev)}
    return {
        "A": a_cache,
        "R": {
            "conv": torch.zeros((n_r, batch, cfg.conv_width - 1, w), dtype=dtype, device=dev),
            "lru": torch.zeros((n_r, batch, w), dtype=torch.float32, device=dev),
        },
    }


@torch.no_grad()
def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, Dict[str, torch.Tensor]], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
    """token (B, 1), pos (B,) -> logits (B, 1, V); ``cache`` is updated in
    place and returned.

    Each A layer's cache is a rotating window: once ``pos >= win`` every KV
    leaf (scales included) rolls one row left and the new row lands in the
    last one.  Keys keep their absolute RoPE phase, so every cached key is in
    the window by construction and no window mask is needed."""
    x = L.embed(params["embedding"], token, cfg.dtype)
    idx = {"R": 0, "A": 0}
    for kind in layer_kinds(cfg):
        lp = _layer(params["groups"][kind], idx[kind])
        h = L.rms_norm(lp["ln1"], x)
        if kind == "A":
            kv = {n: c[idx["A"]] for n, c in cache["A"].items()}
            win = min(cfg.window or kv["k"].shape[1], kv["k"].shape[1])
            full = (pos >= win)[:, None, None, None]
            for c in kv.values():
                c.copy_(torch.where(full, torch.roll(c, -1, dims=1), c))
            h, _ = L.attention_decode(
                lp["attn"], h, kv, pos=pos, rope_theta=cfg.rope_theta,
                slot=torch.clamp(pos, max=win - 1), valid_len=torch.clamp(pos + 1, max=win))
        else:
            st = {"conv": cache["R"]["conv"][idx["R"]], "lru": cache["R"]["lru"][idx["R"]]}
            h, st = recurrent_block_step(lp, h, st)
            cache["R"]["conv"][idx["R"]] = st["conv"]
            cache["R"]["lru"][idx["R"]] = st["lru"]
        x = x + h
        x = x + L.geglu(lp["mlp"], L.rms_norm(lp["ln2"], x))
        idx[kind] += 1
    return _final(params, x, cfg), cache
