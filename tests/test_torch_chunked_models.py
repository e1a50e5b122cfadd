"""Plain PyTorch models of the arithmetic of two CUDA kernels of the port,
written here and never called by the package: they check each design's
numbers on the CPU, where the kernels cannot run.

* ``csrc/rwkv6_scan.cu``'s chunked WKV-6 (``wkv6_chunk_kernel``, the route of
  bf16 outputs): chunks of 16 steps; decays as running products of w floored
  at 1e-30 (every factor <= 1); A summed directly; every f32 operand of a
  product split in a bf16 high part and the bf16 rounding of its remainder
  (hi hi + hi lo + lo hi, or two products against v, exact in bf16); int8
  row scales folded into the f32 operands (v's into A's columns and k's
  rows).  Held to
  ``repro_torch.kernels.ref.rwkv6_scan_ref`` and to the JAX package's
  ``rwkv6_scan`` / ``rwkv6_scan_int8`` (interpret mode, as its own tests run
  them) at ``chip_smoke.py`` phase 13's tolerances: bf16 out within one bf16
  ulp of the largest |out| (each side computes in f32 and rounds once), the
  f32 state within rtol 1e-4 plus 1e-4 of its largest |value|.
* ``csrc/flash_attention.cu``'s int8-K/V tensor-core route
  (``flash_fwd_int8_tc_kernel``): S = (Q K_int8^T) times the k row scale and
  the softmax scale after the product; P times the v row scale in f32 before
  its split into bf16 high and low parts; the online softmax over 64-key
  tiles (32 at head dim 256).  Held to ``flash_attention_q8_ref`` and to the
  JAX ``flash_attention_int8_fwd`` (interpret mode) by phase 17's criterion:
  each bf16 output row within 2 bf16 ulps of that row's largest |value|.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_int8_fwd as jax_flash_int8
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro.kernels.rwkv6_scan import rwkv6_scan_int8 as jax_rwkv6_scan_int8
from repro_torch.kernels import ref as R

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

BF16 = torch.bfloat16
L = 16                  # the chunk


def _bf16(x):
    """float32 values rounded to bf16 and back."""
    return x.to(BF16).float()


def _split(x):
    """x as the kernels feed it to the tensor cores: a bf16 high part and the
    bf16 rounding of the remainder."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mm3(a, b):
    """a @ b with both operands split: hi hi + hi lo + lo hi, f32 sums."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _mm2(a, b):
    """a @ b with a split and b exact in bf16."""
    ah, al = _split(a)
    return ah @ b + al @ b


def _excl_cumprod(w, dim, reverse=False):
    """prod_{i<t} w_i (or, reversed, prod_{i>t} w_i) along ``dim``, as running
    f32 products."""
    if reverse:
        return _excl_cumprod(w.flip(dim), dim).flip(dim)
    ones = torch.ones_like(w.narrow(dim, 0, 1))
    return torch.cat([ones, torch.cumprod(w, dim).narrow(dim, 0, w.shape[dim] - 1)], dim)


def wkv6_chunked_model(r, k, v, w, u, rs=None, ks=None, vs=None):
    """The chunked kernel's arithmetic.  r/k/v (B, S, H, D): bf16 values, or
    int8 integers with (B, S, H, 1) row scales rs/ks/vs; w (B, S, H, D)
    float; u (H, D).  -> (out (B, S, H, D) bf16, state (B, H, D, D) f32)."""
    B, S, H, D = r.shape
    to = lambda x: x.float().permute(0, 2, 1, 3)            # noqa: E731  (B, H, S, .)
    rf, kf, vf, wf = to(r), to(k), to(v), to(w)
    one = torch.ones(B, H, S, 1)
    rsf, ksf, vsf = (one if s is None else to(s) for s in (rs, ks, vs))
    uf = u.float()[None, :, None, :]                         # (1, H, 1, D)
    state = torch.zeros(B, H, D, D)                          # S[d][e]
    outs = []
    for t0 in range(0, S, L):
        n = min(L, S - t0)
        pad = (0, 0, 0, L - n)

        def chunk(x):
            return torch.nn.functional.pad(x[:, :, t0:t0 + n], pad)

        r_c = chunk(rf) * chunk(rsf)                         # f32 values (scale folded)
        k_c = chunk(kf) * chunk(ksf)
        v_c, vs_c = chunk(vf), chunk(vsf)                    # v exact; its scale goes to A, k
        w_c = torch.nn.functional.pad(torch.clamp(wf[:, :, t0:t0 + n], min=1e-30), pad,
                                      value=1.0)             # rows past S pass the state
        pre, suf = _excl_cumprod(w_c, 2), _excl_cumprod(w_c, 2, reverse=True)
        pre_l = pre[:, :, -1] * w_c[:, :, -1]                # the chunk's decay (B, H, D)
        kv = k_c * vs_c
        # inter: (r (.) pre) S0; the state split in two parts too
        out = _mm3(r_c * pre, state)
        # A, summed directly (decays as running products)
        A = torch.zeros(B, H, L, L)
        for t in range(L):
            A[:, :, t, t] = (r_c[:, :, t] * uf[:, :, 0] * kv[:, :, t]).sum(-1)
            dec = torch.ones(B, H, D)
            for j in range(t - 1, -1, -1):
                if j < t - 1:
                    dec = dec * w_c[:, :, j + 1]
                A[:, :, t, j] = (r_c[:, :, t] * dec * kv[:, :, j]).sum(-1)
        out = out + _mm2(A, v_c)
        outs.append(out[:, :, :n])
        state = pre_l[..., None] * state + _mm2((kv * suf).transpose(-1, -2), v_c)
    out = torch.cat(outs, 2).permute(0, 2, 1, 3)
    return out.to(BF16), state


def _wkv_inputs(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, D)) * 0.5)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    r, k, v, w = (_bf16(torch.from_numpy(a)) for a in (r, k, v, w))     # bf16 values
    return r, k, v, w, torch.from_numpy(u)


def _hold_wkv(out, state, want_out, want_state):
    """Phase 13's tolerances: bf16 out within one bf16 ulp of the largest
    |out|; the state within rtol 1e-4 plus 1e-4 of its largest |value|."""
    want_out = torch.as_tensor(np.array(want_out)).to(BF16).float()
    want_state = torch.as_tensor(np.array(want_state)).float()
    ulp = 2.0 ** (np.frexp(want_out.abs().max().item())[1] - 8)
    assert (out.float() - want_out).abs().max().item() <= ulp
    torch.testing.assert_close(state, want_state, rtol=1e-4,
                               atol=1e-4 * want_state.abs().max().item())


WKV_CASES = [(S, D) for S in (1, 31, 32, 45, 300) for D in (16, 64)]


@pytest.mark.parametrize("S,D", WKV_CASES, ids=[f"S{S}-D{D}" for S, D in WKV_CASES])
def test_chunked_wkv6_model_matches_plain_and_jax(S, D):
    """bf16 r/k/v/w: S 1 (one short chunk), 31 and 45 (ragged), 32 (two
    whole chunks), 300 (nineteen chunks, the last ragged); D 16 and 64."""
    r, k, v, w, u = _wkv_inputs(1, S, 2, D, seed=S * 100 + D)
    out, state = wkv6_chunked_model(r, k, v, w, u)
    assert out.shape == r.shape and state.shape == (1, 2, D, D)
    _hold_wkv(out, state, *R.rwkv6_scan_ref(r, k, v, w, u))
    jout, jstate = jax_rwkv6_scan(*(jnp.asarray(t.numpy()) for t in (r, k, v, w, u)),
                                  interpret=True)
    _hold_wkv(out, state, jout, jstate)


@pytest.mark.parametrize("S,D", WKV_CASES, ids=[f"S{S}-D{D}" for S, D in WKV_CASES])
def test_chunked_wkv6_int8_model_matches_plain_and_jax(S, D):
    """int8 r/k/v at the training quantizer's rows (round half up), bf16 out:
    the row scales folded into the f32 operands, v's into A's columns."""
    r, k, v, w, u = _wkv_inputs(1, S, 2, D, seed=S * 100 + D + 7)
    (rq, rs), (kq, ks), (vq, vs) = (R.quantize_int8_ref(t, 0.5) for t in (r, k, v))
    out, state = wkv6_chunked_model(rq, kq, vq, w, u, rs, ks, vs)
    deq = (R.dequantize_int8_ref(q, s) for q, s in ((rq, rs), (kq, ks), (vq, vs)))
    _hold_wkv(out, state, *R.rwkv6_scan_ref(*deq, w, u))
    jout, jstate = jax_rwkv6_scan_int8(
        *(jnp.asarray(t.numpy()) for t in (rq, rs, kq, ks, vq, vs, w, u)), interpret=True)
    _hold_wkv(out, state, jout, jstate)


def flash_q8_fold_model(q, kq, ks, vq, vs, *, causal, window):
    """The int8-K/V tensor-core route's arithmetic: q (B, Sq, H, D) bf16
    values, kq/vq (B, Skv, Hkv, D) int8 with (B, Skv, Hkv, 1) scales ->
    (B, Sq, H, D) bf16."""
    B, Sq, H, D = q.shape
    Skv, Hkv = kq.shape[1], kq.shape[2]
    bk = 32 if D >= 256 else 64
    scale = np.float32(1.0 / np.sqrt(D))
    rep = lambda x: x.float().repeat_interleave(H // Hkv, dim=2).transpose(1, 2)  # noqa: E731
    qf, kf, vf, ksf, vsf = q.float().transpose(1, 2), rep(kq), rep(vq), rep(ks), rep(vs)
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Skv, bk):
        keys = torch.arange(k0, min(k0 + bk, Skv))[None, :]
        s = (qf @ kf[:, :, keys[0]].transpose(-1, -2)) * ksf[:, :, keys[0], 0][:, :, None, :]
        s = s * scale
        live = torch.ones(Sq, keys.shape[1], dtype=torch.bool)
        if causal:
            live &= keys <= rows
        if window is not None:
            live &= keys > rows - window
        s = torch.where(live, s, torch.tensor(-float("inf")))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p * vsf[:, :, keys[0], 0][:, :, None, :]        # v scale in f32, then the split
        acc = acc * corr + _mm2(pv, vf[:, :, keys[0]])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).transpose(1, 2).to(BF16)


def _hold_rows(got, want, ulps=2):
    """Phase 17's criterion: each row within ``ulps`` bf16 ulps of that
    row's largest |want|."""
    got, want = got.float(), torch.as_tensor(np.array(want)).to(BF16).float()
    rowmax = want.abs().amax(-1, keepdim=True)
    bound = torch.where(rowmax > 0, ulps * torch.exp2(torch.frexp(rowmax).exponent - 8.0),
                        torch.zeros_like(rowmax))
    assert bool(((got - want).abs() <= bound).all())


FLASH8_CASES = [(D, mode) for D in (32, 128, 256) for mode in ("causal", "window")]


@pytest.mark.parametrize("D,mode", FLASH8_CASES, ids=[f"D{D}-{m}" for D, m in FLASH8_CASES])
def test_flash_q8_scale_fold_matches_plain_and_jax(D, mode):
    """100 queries and keys (not a multiple of the 64-key tiles), GQA (2 query
    heads a kv head), causal, or causal with a window of 24."""
    window = 24 if mode == "window" else None
    rng = np.random.default_rng(D)
    B, S, H, Hkv = 1, 100, 4, 2
    q = _bf16(torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)))
    k, v = (_bf16(torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32)))
            for _ in range(2))
    (kq, ks), (vq, vs) = R.quantize_int8_ref(k, 0.5), R.quantize_int8_ref(v, 0.5)
    got = flash_q8_fold_model(q, kq, ks, vq, vs, causal=True, window=window)
    _hold_rows(got, R.flash_attention_q8_ref(q, k, v, causal=True, window=window))
    want = jax_flash_int8(*(jnp.asarray(t.numpy()) for t in (q, kq, ks, vq, vs)),
                          causal=True, window=window, interpret=True)
    _hold_rows(got, want)
