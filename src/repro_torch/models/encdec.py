"""Whisper-style encoder-decoder transformer (whisper-medium backbone), port of
:mod:`repro.models.encdec`.

The audio conv frontend is a stub, as in the reference: callers pass frame
embeddings (B, n_frames, d_model).  The encoder adds sinusoidal positions
and attends bidirectionally (the flash op, ``causal=False``); the decoder
adds learned positions (a 448-row table) and runs causal self-attention,
cross-attention against the encoder output and a GELU MLP.  LayerNorm, QKV
and MLP biases, pre-norm, logits from the tied embedding.

Entry points:
  * ``init_params(cfg, seed=..., device=...)``                 -> (params, axes)
  * ``encode(params, cfg, frames)``                            -> encoder output
  * ``forward(params, cfg, tokens, frames=...)``               -> logits
  * ``init_cache(cfg, batch, cache_len, device=...)``          -> zeroed cache
  * ``cache_logical_axes(cfg)``                                -> the cache's logical axes
  * ``prefill(params, cfg, tokens, cache_len, frames=...)``    -> (last logits, cache)
  * ``decode_step(params, cfg, token, cache, pos)``            -> (logits, cache)

The cache holds the decoder's self-attention K/V (``k``, ``v``: (L, B,
cache_len, Hkv, D)) and every layer's cross-attention K/V over the frames
(``xk``, ``xv``: (L, B, n_frames, Hkv, D)), written once by ``prefill``;
an int8 cache stores all four as int8 rows plus f32 row scales (8 leaves).

On a mesh with a ``model`` axis the training forward is tensor-parallel
(:class:`~repro_torch.distributed.tensor.TensorPlan`): the encoder's and the
decoder's attention and MLPs run the rank's heads and FFN columns, the
cross-attention's query heads read the rank's K/V heads of the encoder
output (which passes a copy-in: its gradient, the rank's heads' part, is
summed once), and the tied embedding and head split the vocabulary.
Prefill runs the encoder so too (the flash kernel at the rank's heads over
the frames) and the decoder at the rank's heads; the self and cross K/V
caches hold the rank's KV heads (``cache_logical_axes``, the reference's
table), every KV head where the axis does not divide them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tensor
from repro_torch.kernels import ref as KR
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.dense import _layer, _run_layer, tensor_plan
from repro_torch.models.param import ParamBuilder, build, normal_init, stacked

PyTree = Any
MAX_DEC_LEN = 448          # whisper's decoder position table


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) float32: sines of the first half of the
    channels' timescales, then cosines (the encoder's positions)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32,
                                                  device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def _init_enc_layer(s, cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    L.init_layernorm(s, "ln1", cfg.d_model)
    L.init_attention(s, "attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd, qkv_bias=True)
    L.init_layernorm(s, "ln2", cfg.d_model)
    L.init_gelu_mlp(s, "mlp", cfg.d_model, cfg.d_ff, bias=True)


def _init_dec_layer(s, cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    L.init_layernorm(s, "ln1", cfg.d_model)
    L.init_attention(s, "self_attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                     qkv_bias=True)
    L.init_layernorm(s, "ln_x", cfg.d_model)
    L.init_attention(s, "cross_attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                     qkv_bias=True)
    L.init_layernorm(s, "ln2", cfg.d_model)
    L.init_gelu_mlp(s, "mlp", cfg.d_model, cfg.d_ff, bias=True)


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
        b.param("dec_pos", (MAX_DEC_LEN, cfg.d_model), ("pos", "embed"), init=normal_init(0.01))
        _init_enc_layer(stacked(b, cfg.n_enc_layers).scope("enc_blocks"), cfg)
        L.init_layernorm(b, "ln_enc", cfg.d_model)
        _init_dec_layer(stacked(b, cfg.n_dec_layers).scope("dec_blocks"), cfg)
        L.init_layernorm(b, "ln_dec", cfg.d_model)

    return build(f, seed=seed, abstract=abstract, dtype=dtype or cfg.dtype, device=dev)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params: PyTree, cfg: ModelConfig, frames: torch.Tensor, tp=None) -> torch.Tensor:
    """frames (B, n_frames, d_model), the stubbed frontend's output ->
    encoder output (B, n_frames, d_model), whole on every rank under ``tp``."""
    if frames is None:
        raise ValueError("encdec: encode needs frames (B, n_frames, d_model)")
    x = frames.to(cfg.dtype) + sinusoids(frames.shape[1], cfg.d_model,
                                         device=frames.device).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(lp, h):
        a = L.attention_train(lp["attn"], L.layer_norm(lp["ln1"], h), positions=positions,
                              causal=False, use_rope=False, precision=cfg.train_precision,
                              tp=tp)
        h = h + a
        return h + L.gelu_mlp(lp["mlp"], L.layer_norm(lp["ln2"], h), tp)

    for i in range(cfg.n_enc_layers):
        x = _run_layer(cfg, body, _layer(params["enc_blocks"], i), x)
    return L.layer_norm(params["ln_enc"], x)


# ---------------------------------------------------------------------------
# Decoder (train)
# ---------------------------------------------------------------------------


def _dec_positions(params: PyTree, S: int) -> torch.Tensor:
    """Rows ``0 .. S - 1`` of the position table, clamped to its last row."""
    table = params["dec_pos"]
    return table[torch.clamp(torch.arange(S, device=table.device), max=table.shape[0] - 1)]


def _embed_dec(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
               tp=None) -> torch.Tensor:
    x = L.embed(params["embedding"], tokens, cfg.dtype, tp)
    return x + _dec_positions(params, tokens.shape[1]).to(cfg.dtype)


def decode_train(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, tp=None) -> torch.Tensor:
    """The decoder over ``tokens`` against ``enc_out`` -> logits (B, S, V),
    under ``tp`` the rank's vocabulary columns."""
    x = _embed_dec(params, cfg, tokens, tp)
    positions = torch.arange(tokens.shape[1], device=x.device)
    # every layer's cross K/V of the rank's KV heads read the encoder output
    # through one copy-in: one all-reduce of its gradient a step
    ctx = tensor.copy_in(enc_out, tp.axis) if tp is not None and tp.kv_heads else enc_out

    def body(lp, h):
        a = L.attention_train(lp["self_attn"], L.layer_norm(lp["ln1"], h), positions=positions,
                              causal=True, use_rope=False, precision=cfg.train_precision,
                              tp=tp)
        h = h + a
        ck, cv = L.cross_kv(lp["cross_attn"], ctx)
        h = h + L.cross_attention(lp["cross_attn"], L.layer_norm(lp["ln_x"], h), ck, cv, tp)
        return h + L.gelu_mlp(lp["mlp"], L.layer_norm(lp["ln2"], h), tp)

    for i in range(cfg.n_dec_layers):
        x = _run_layer(cfg, body, _layer(params["dec_blocks"], i), x)
    x = L.layer_norm(params["ln_dec"], x)
    return L.logits(params["embedding"], x, tp)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder over ``frames``, then the decoder over ``tokens`` -> logits
    (B, S, V); on a mesh with a ``model`` axis, tensor-parallel."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        return decode_train(params, cfg, tokens, encode(params, cfg, frames, tp), tp)


# ---------------------------------------------------------------------------
# Decoder (serve): self-KV cache + precomputed cross-KV
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim()
    kv_shape = (cfg.n_dec_layers, batch, cache_len, cfg.n_kv_heads, hd)
    x_shape = (cfg.n_dec_layers, batch, cfg.n_frames, cfg.n_kv_heads, hd)
    if cfg.kv_cache_dtype == "int8":
        # the self-attention K/V and the (large, static) cross K/V both keep
        # per-row symmetric int8 + f32 scale columns
        cache = {}
        for prefix, shape in (("", kv_shape), ("x", x_shape)):
            for name in ("k", "v"):
                cache[prefix + name] = torch.zeros(shape, dtype=torch.int8, device=dev)
                cache[prefix + name + "_scale"] = torch.zeros(
                    shape[:-1] + (1,), dtype=torch.float32, device=dev)
        return cache
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(kv_shape, dtype=dtype, device=dev),
            "v": torch.zeros(kv_shape, dtype=dtype, device=dev),
            "xk": torch.zeros(x_shape, dtype=dtype, device=dev),
            "xv": torch.zeros(x_shape, dtype=dtype, device=dev)}


def cache_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """The cache's logical axes (``repro/models/encdec.py:177``)."""
    kv = ("layers", "batch", "kv_seq", "act_kv_heads", None)
    x = ("layers", "batch", None, "act_kv_heads", None)
    if cfg.kv_cache_dtype == "int8":
        return {"k": kv, "k_scale": kv, "v": kv, "v_scale": kv,
                "xk": x, "xk_scale": x, "xv": x, "xv_scale": x}
    return {"k": kv, "v": kv, "xk": x, "xv": x}


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int, *,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode the frames, run the decoder prompt; return last-position logits
    (B, 1, V) and the decode-ready cache: self K/V padded to ``cache_len``
    and every layer's cross K/V over the frames.  Tensor-parallel on a mesh
    with a ``model`` axis (the module doc)."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        enc_out = encode(params, cfg, frames, tp)
        x = _embed_dec(params, cfg, tokens, tp)
        positions = torch.arange(tokens.shape[1], device=x.device)
        layers: List[Dict[str, torch.Tensor]] = []
        for i in range(cfg.n_dec_layers):
            lp = _layer(params["dec_blocks"], i)
            a, kv = L.attention_prefill(
                lp["self_attn"], L.layer_norm(lp["ln1"], x), positions=positions,
                cache_len=cache_len, causal=True, use_rope=False,
                kv_cache_dtype=cfg.kv_cache_dtype, tp=tp)
            x = x + a
            ck, cv = L.cross_kv(lp["cross_attn"], enc_out)
            x = x + L.cross_attention(lp["cross_attn"], L.layer_norm(lp["ln_x"], x), ck, cv, tp)
            x = x + L.gelu_mlp(lp["mlp"], L.layer_norm(lp["ln2"], x), tp)
            if cfg.kv_cache_dtype == "int8":
                (xkq, xks), (xvq, xvs) = KR.quantize_int8_ref(ck), KR.quantize_int8_ref(cv)
                kv.update(xk=xkq, xk_scale=xks, xv=xvq, xv_scale=xvs)
            else:
                kv.update(xk=ck, xv=cv)
            layers.append(kv)
        x = L.layer_norm(params["ln_dec"], x)
        cache = {k: torch.stack([kv[k] for kv in layers]) for k in layers[0]}
        return tensor.whole_logits(L.logits(params["embedding"], x[:, -1:], tp), tp), cache


@torch.no_grad()
def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token (B, 1), pos (B,) -> logits (B, 1, V).  The self K/V row at
    ``pos`` is written in place; the cross K/V are only read.
    Tensor-parallel on a mesh with a ``model`` axis (the module doc)."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        x = L.embed(params["embedding"], token, cfg.dtype, tp)
        table = params["dec_pos"]
        x = x + table[torch.clamp(pos.long(), max=table.shape[0] - 1)][:, None].to(cfg.dtype)
        for i in range(cfg.n_dec_layers):
            lp = _layer(params["dec_blocks"], i)
            kv = _layer(cache, i)
            self_kv = {n: t for n, t in kv.items() if not n.startswith("x")}
            a, _ = L.attention_decode(lp["self_attn"], L.layer_norm(lp["ln1"], x), self_kv,
                                      pos=pos, use_rope=False, tp=tp)
            x = x + a
            x = x + L.cross_attention_decode(lp["cross_attn"], L.layer_norm(lp["ln_x"], x),
                                             kv, tp)
            x = x + L.gelu_mlp(lp["mlp"], L.layer_norm(lp["ln2"], x), tp)
        x = L.layer_norm(params["ln_dec"], x)
        return tensor.whole_logits(L.logits(params["embedding"], x, tp), tp), cache


def decode_writes(cfg: ModelConfig, cache: Dict[str, torch.Tensor], pos: Sequence[int],
                  rows: Sequence[int]) -> List[Tuple[torch.Tensor, Tuple[Any, ...]]]:
    """(leaf, index) pairs covering what ``decode_step`` writes for the batch
    ``rows`` at host positions ``pos``: the self K/V row at ``pos`` (and its
    scales); the cross K/V leaves are never written."""
    dev = cache["k"].device
    at = (slice(None), torch.tensor(list(rows), dtype=torch.long, device=dev),
          torch.tensor([int(pos[r]) for r in rows], dtype=torch.long, device=dev))
    return [(leaf, at) for name, leaf in cache.items() if not name.startswith("x")]
