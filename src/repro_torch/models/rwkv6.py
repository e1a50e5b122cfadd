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

On a mesh whose ``model`` axis splits the ``lru`` channels (whole heads a
rank, :func:`repro_torch.distributed.tensor.plan_for`) the training forward
is tensor-parallel: a rank computes r, k, v, g and the decay of its heads
(the WKV scan at (B, S, H/m, D)), their group norm and gate, and its rows of
``wo`` (a reduce-out); channel mixing splits its FFN columns as the dense
MLP does, and its gate r (column-sharded by ``cmix.wr``) is gathered whole
before it gates the reduced output.  The ``mu_*`` vectors are ``lru``
pieces that mix the whole ``x``, so they are gathered whole; the decay
LoRA's ``wa`` is replicated, so ``tanh(x_w wa)`` is computed whole on
every rank and copied in after it.

Serving on the same mesh runs those pieces too: ``prefill`` the WKV scan at
the rank's heads, ``decode_step`` the one-token step at them.  The cache
holds the rank's ``lru`` pieces (``cache_logical_axes``, the reference's
table): its heads of ``wkv``, its channels of ``tshift`` and ``cshift``.
The mixes read the previous x whole, so each step first gathers a layer's
two shifts whole, with its mix vectors, in one all-gather.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tensor
from repro_torch.distributed.sharding import with_logical_constraint as wlc
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.dense import _layer, _scan_blocks, embedding, head, tensor_plan
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


def _whole_mus(p: Dict, partial: Dict[str, bool], tp, width: int
               ) -> Dict[str, torch.Tensor]:
    """The mix vectors named in ``partial``, whole (``width`` channels).
    Under an ``lru`` split each is the rank's piece, gathered in one
    all-gather a kind: where the rank's gradient of the whole vector is a
    partial sum (``partial[name]``: it mixes the input of the rank's
    columns) the backward reduce-scatters it, else (whole on every rank) it
    keeps the rank's slice.  Vectors already whole (a decode step's,
    :func:`_gather_step`) pass as they are."""
    if tp is None or not tp.lru or all(p[name].shape[-1] == width for name in partial):
        return {name: p[name] for name in partial}
    out = {}
    for summed in (True, False):
        names = [name for name, k in partial.items() if k == summed]
        if names:
            pieces = torch.stack([p[name] for name in names])
            whole = (tensor.gather_weight(pieces, 1, tp.axis) if summed
                     else tensor.gather_features(pieces, tp.axis))
            out.update(zip(names, whole.unbind(0)))
    return out


def _group_norm(p: Dict, x: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Head-wise group norm over (B, S, H, D), flattened back to channels."""
    B, S, H, D = x.shape
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, S, H * D)
    return (y * p["gn_scale"].float() + p["gn_bias"].float()).to(x.dtype)


def time_mix(p: Dict, x: torch.Tensor, cfg: ModelConfig,
             state: Optional[Dict] = None, tp=None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d).  ``state`` None: the whole prompt through the scan op;
    otherwise one decode token against ``{"shift": (B, d), "wkv": (B, H, D, D)}``.
    Returns (out, {"shift": x[:, -1], "wkv": state after the last position}).
    Under ``tp`` the rank's heads, as the module doc says (``state`` then
    holds the whole shift and the rank's heads' ``wkv``)."""
    hd = cfg.rwkv_head_dim
    B, S, d = x.shape
    mix = _mixer(x, _token_shift(x, state["shift"] if state else None))
    if tp is not None and tp.lru:
        # r, k, v, g read the copied-in x (their gradients are the rank's
        # columns' parts, summed once); the decay's whole LoRA input reads
        # x itself, its gradient whole on every rank
        xc = tensor.copy_in(x, tp.axis)
        mix_c = _mixer(xc, _token_shift(xc, state["shift"] if state else None))
        mu = _whole_mus(p, {"mu_r": True, "mu_k": True, "mu_v": True, "mu_g": True,
                            "mu_w": False}, tp, d)
        lora = tensor.copy_in(torch.tanh(mix(mu["mu_w"]) @ p["wa"].to(x.dtype)), tp.axis)
    else:
        mix_c, mu = mix, p
        lora = torch.tanh(mix(p["mu_w"]) @ p["wa"].to(x.dtype))

    r = mix_c(mu["mu_r"]) @ p["wr"].to(x.dtype)
    k = mix_c(mu["mu_k"]) @ p["wk"].to(x.dtype)
    v = mix_c(mu["mu_v"]) @ p["wv"].to(x.dtype)
    g = mix_c(mu["mu_g"]) @ p["wg"].to(x.dtype)
    decay_in = lora @ p["wb"].to(x.dtype)
    w = torch.exp(-torch.exp(torch.clamp(p["w0"].float() + decay_in.float(), -10.0, 5.0)))
    H = r.shape[-1] // hd              # this rank's heads

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

    out = wlc(_group_norm(p, out) * F.silu(g), "batch", "seq", "lru")
    y = out @ p["wo"].to(x.dtype)
    if tp is not None and tp.lru:
        y = tensor.reduce_out(y, tp.axis)
    return y, {"shift": x[:, -1], "wkv": s_new}


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


def channel_mix(p: Dict, x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                tp=None) -> torch.Tensor:
    """``sigmoid(x_r wr) * (relu(x_k wk)^2 wv)``.  Under ``tp`` the rank's
    ``lru`` columns of r, gathered whole (its gradient, whole, comes back
    as the rank's slice), and its FFN columns of k with a reduce-out."""
    split_r = tp is not None and tp.lru
    split_k = tp is not None and tp.mlp
    mix = _mixer(x, _token_shift(x, shift))
    if split_r:
        # the mix vectors are lru pieces, gathered whole; they mix the
        # copied-in x where the rank's columns read it
        xc = tensor.copy_in(x, tp.axis)
        mix_c = _mixer(xc, _token_shift(xc, shift))
        mu = _whole_mus(p, {"mu_r": True, "mu_k": split_k}, tp, x.shape[-1])
        x_r, x_k = mix_c(mu["mu_r"]), (mix_c if split_k else mix)(mu["mu_k"])
    else:
        # whole mix vectors: their gradients stay whole, the copy-in after them
        x_r, x_k = mix(p["mu_r"]), mix(p["mu_k"])
        if split_k:
            x_k = tensor.copy_in(x_k, tp.axis)
    r = torch.sigmoid(x_r @ p["wr"].to(x.dtype))
    if split_r:
        r = tensor.gather_features(r, tp.axis)
    k = torch.square(torch.relu(x_k @ p["wk"].to(x.dtype)))
    kv = wlc(k, "batch", "seq", "act_mlp") @ p["wv"].to(x.dtype)
    if split_k:
        kv = tensor.reduce_out(kv, tp.axis)
    return r * kv


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


def _logits(params: PyTree, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    x = L.layer_norm(params["ln_f"], x)
    return L.logits(head(params, cfg), x, tp)


def _block_train(lp: Dict, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    h, _ = time_mix(lp["tmix"], L.layer_norm(lp["ln1"], x), cfg, tp=tp)
    x = x + h
    return x + channel_mix(lp["cmix"], L.layer_norm(lp["ln2"], x), tp=tp)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Training forward. tokens: (B, S) int -> logits (B, S, V); on a mesh
    with a ``model`` axis, tensor-parallel (the logits are then this rank's
    vocabulary columns where the axis divides the vocabulary)."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        x = L.embed(embedding(params), tokens, cfg.dtype, tp)
        x = L.layer_norm(params["ln0"], x)
        x = _scan_blocks(params, x, cfg, lambda lp, h: _block_train(lp, h, cfg, tp))
        return _logits(params, cfg, x, tp)


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


def cache_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """The state's logical axes (``repro/models/rwkv6.py:319``): ``wkv``'s
    heads and the shifts' channels over ``lru``."""
    return {"tshift": ("layers", "batch", "lru"), "cshift": ("layers", "batch", "lru"),
            "wkv": ("layers", "batch", "lru", None, None)}


_STEP_MUS = (("tmix", ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")), ("cmix", ("mu_r", "mu_k")))


def _gather_step(lp: Dict, tshift: torch.Tensor, cshift: torch.Tensor, dtype: torch.dtype,
                 tp) -> Tuple[torch.Tensor, torch.Tensor, Dict, Dict]:
    """A decode step's shifts and mix vectors of one layer whole: the
    rank's pieces (B, d/m) and (d/m,) in one all-gather, in the
    activations' ``dtype`` (where the mixes cast the vectors anyway) ->
    (tshift, cshift, the time mix's and the channel mix's params with their
    mix vectors whole)."""
    B = tshift.shape[0]
    pieces = [tshift, cshift] + [lp[kind][n][None] for kind, names in _STEP_MUS
                                 for n in names]
    whole = tensor.gather_features(torch.cat([t.to(dtype) for t in pieces]), tp.axis)
    out, i = {}, 2 * B
    for kind, names in _STEP_MUS:
        out[kind] = dict(lp[kind], **dict(zip(names, whole[i:i + len(names)].unbind(0))))
        i += len(names)
    return whole[:B], whole[B:2 * B], out["tmix"], out["cmix"]


def _lru_piece(x: torch.Tensor, tp) -> torch.Tensor:
    """The rank's ``lru`` channels of a whole (B, d) shift (itself where
    the plan does not split them)."""
    if tp is None or not tp.lru:
        return x
    n = x.shape[-1] // tp.axis.size
    return x[..., tp.axis.index * n:(tp.axis.index + 1) * n]


@torch.no_grad()
def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt; return (last-position logits (B, 1, V), decode-ready
    state).  Tensor-parallel on a mesh with a ``model`` axis (the module
    doc)."""
    tp, sizes = tensor_plan(cfg)
    with sizes:
        x = L.embed(params["embedding"], tokens, cfg.dtype, tp)
        x = L.layer_norm(params["ln0"], x)
        tshift, cshift, wkv = [], [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            t_out, st = time_mix(lp["tmix"], L.layer_norm(lp["ln1"], x), cfg, tp=tp)
            tshift.append(_lru_piece(st["shift"], tp))
            wkv.append(st["wkv"])
            x = x + t_out
            xn = L.layer_norm(lp["ln2"], x)
            cshift.append(_lru_piece(xn[:, -1], tp))
            x = x + channel_mix(lp["cmix"], xn, tp=tp)
        cache = {"tshift": torch.stack(tshift), "cshift": torch.stack(cshift),
                 "wkv": torch.stack(wkv)}
        return tensor.whole_logits(_logits(params, cfg, x[:, -1:], tp), tp), cache


@torch.no_grad()
def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token (B, 1) -> logits (B, 1, V).  ``cache`` is updated in place (the
    JAX package donates it) and returned; ``pos`` is unused (O(1) state).
    Tensor-parallel on a mesh with a ``model`` axis (the module doc)."""
    tp, sizes = tensor_plan(cfg)
    split = tp is not None and tp.lru
    with sizes:
        x = L.embed(params["embedding"], token, cfg.dtype, tp)
        x = L.layer_norm(params["ln0"], x)
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            tshift, cshift, tmix, cmix = cache["tshift"][i], cache["cshift"][i], \
                lp["tmix"], lp["cmix"]
            if split:
                tshift, cshift, tmix, cmix = _gather_step(lp, tshift, cshift, cfg.dtype, tp)
            xn = L.layer_norm(lp["ln1"], x)
            t_out, st = time_mix(tmix, xn, cfg, state={"shift": tshift, "wkv": cache["wkv"][i]},
                                 tp=tp)
            x = x + t_out
            xn = L.layer_norm(lp["ln2"], x)
            c_out = channel_mix(cmix, xn, cshift, tp=tp)
            x = x + c_out
            cache["tshift"][i] = _lru_piece(st["shift"], tp)
            cache["wkv"][i] = st["wkv"]
            cache["cshift"][i] = _lru_piece(xn[:, -1], tp)
        return tensor.whole_logits(_logits(params, cfg, x, tp), tp), cache


def decode_writes(cfg: ModelConfig, cache: Dict[str, torch.Tensor], pos: Sequence[int],
                  rows: Sequence[int]) -> List[Tuple[torch.Tensor, Tuple[Any, ...]]]:
    """(leaf, index) pairs that cover everything ``decode_step`` writes for
    the batch ``rows``: the whole state of each (``pos`` is unused)."""
    at = (slice(None), torch.tensor(list(rows), dtype=torch.long, device=cache["wkv"].device))
    return [(leaf, at) for leaf in cache.values()]
