"""repro_torch.kernels.ops on CPU tensors (the plain PyTorch versions) against
the JAX package's ops, run in Pallas interpret mode as tests/test_kernels.py
runs them.  Inputs are made once with numpy and handed to both packages.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each of them to these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

# f32 tolerance: the Pallas kernels fold the softmax block by block (online
# rescaling) while the plain versions take one softmax over the whole row, so
# the two differ by float32 reassociation only.
ATOL, RTOL = 2e-5, 1e-5


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(port: torch.Tensor, jax_out) -> None:
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window
    (2, 32, 32, 4, 4, 16, True, None),
    (2, 40, 40, 4, 2, 16, True, None),      # GQA 2, ragged vs block 16
    (1, 37, 37, 4, 1, 32, True, 8),         # MQA, window 8, ragged
    (2, 24, 29, 4, 4, 16, False, None),     # Sq != Skv, not causal
    (1, 40, 20, 4, 2, 16, False, 8),        # rows past Skv+window: fully masked -> 0
    (1, 19, 19, 4, 4, 128, True, None),     # the full config's head dim
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_attention_matches_jax(case):
    B, Sq, Skv, H, Hkv, D, causal, window = case
    q, k, v = _np((B, Sq, H, D), 1), _np((B, Skv, Hkv, D), 2), _np((B, Skv, Hkv, D), 3)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, block=16, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(got, want)
    # on a CPU tensor the op IS its plain version
    assert torch.equal(got, R.flash_attention_ref(tq, tk, tv, causal=causal, window=window))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JR.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)),
        atol=ATOL, rtol=RTOL)


def test_flash_attention_fully_masked_rows_are_zero():
    q, k, v = _np((1, 40, 4, 16), 4), _np((1, 20, 2, 16), 5), _np((1, 20, 2, 16), 6)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              window=8)
    assert torch.count_nonzero(out[:, 28:]) == 0       # q_pos - 8 >= 19: nothing live
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# decode attention (native and int8 cache)
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # B, Skv, H, Hkv, D, valid_len, window
    (4, 37, 4, 4, 16, (0, 1, 20, 37), None),     # valid 0 and full
    (3, 50, 4, 2, 16, (13, 50, 7), None),        # GQA 2, ragged
    (3, 29, 4, 1, 32, (29, 5, 0), 8),            # MQA, window 8
    (2, 577, 4, 4, 128, (576, 300), None),       # the full config's head dim / cache_len
]


def _decode_inputs(case):
    B, Skv, H, Hkv, D, valid, window = case
    q, k, v = _np((B, 1, H, D), 7), _np((B, Skv, Hkv, D), 8), _np((B, Skv, Hkv, D), 9)
    return q, k, v, np.asarray(valid, np.int32), window


@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
def test_decode_attention_matches_jax(case):
    q, k, v, valid, window = _decode_inputs(case)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(valid), window=window, block_k=16,
                                 interpret=True)
    tq, tk, tv, tvl = (torch.from_numpy(a) for a in (q, k, v, valid))
    got = ops.decode_attention(tq, tk, tv, tvl, window=window)
    _close(got, want)
    assert torch.equal(got, R.decode_attention_ref(tq, tk, tv, tvl, window=window))
    assert torch.count_nonzero(got[valid == 0]) == 0


@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
def test_decode_attention_int8_matches_jax(case):
    q, kf, vf, valid, window = _decode_inputs(case)
    rng = np.random.default_rng(10)
    k = rng.integers(-127, 128, kf.shape).astype(np.int8)
    v = rng.integers(-127, 128, vf.shape).astype(np.int8)
    ks = (rng.random(kf.shape[:3] + (1,)) * 0.05).astype(np.float32)
    vs = (rng.random(vf.shape[:3] + (1,)) * 0.05).astype(np.float32)
    want = jops.decode_attention_int8(
        *(jnp.asarray(a) for a in (q, k, ks, v, vs, valid)), window=window,
        block_k=16, interpret=True)
    targs = [torch.from_numpy(a) for a in (q, k, ks, v, vs, valid)]
    got = ops.decode_attention_int8(*targs, window=window)
    _close(got, want)
    assert torch.equal(got, R.decode_attention_int8_ref(*targs, window=window))


# ---------------------------------------------------------------------------
# int8 quantizer of the serving cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 9, 4, 16), (3, 1, 2, 128)])
def test_quantize_int8_ref_bit_identical(shape):
    x = _np(shape, 11) * 3.0
    x[0, 0, 0, :] = 0.0                                  # absmax 0 -> scale floor
    q, s = R.quantize_int8_ref(torch.from_numpy(x))
    jq, js = JR.quantize_int8_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        R.dequantize_int8_ref(q, s).numpy(), np.asarray(JR.dequantize_int8_ref(jq, js)))


def test_quantize_int8_ref_rounds_half_to_even():
    # absmax 127 gives scale 1, so x/scale hits the .5 ties exactly
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49]], np.float32)
    q, s = R.quantize_int8_ref(torch.from_numpy(x))
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 3]]
    np.testing.assert_array_equal(q.numpy(), np.asarray(JR.quantize_int8_ref(jnp.asarray(x))[0]))


# ---------------------------------------------------------------------------
# int8 row quantizer of int8-fused training (the TPU kernel _quantize_rows)
# ---------------------------------------------------------------------------

QUANT_CASES = [
    # R, N, noise, dtype — R ragged against the TPU kernel's 8-row and 256-row tiles
    (5, 16, "half", np.float32),
    (37, 128, "random", np.float32),
    (300, 128, "half", np.float32),
    (9, 512, "random", np.float32),
    (21, 128, "half", "bfloat16"),
]


def _quant_inputs(R, N, noise_kind, dtype):
    rng = np.random.default_rng(R * 1000 + N)
    x = (rng.standard_normal((R, N)) * 3.0).astype(np.float32)
    x[0] = 0.0                                           # absmax 0 -> scale floor
    noise = (np.full((R, N), 0.5, np.float32) if noise_kind == "half"
             else rng.random((R, N)).astype(np.float32))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":                              # both round f32 -> bf16 to nearest even
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx, noise


@pytest.mark.parametrize("case", QUANT_CASES, ids=[str(c[:3]) + str(c[3]) for c in QUANT_CASES])
def test_quantize_int8_bit_identical_to_jax_kernel(case):
    """int8 bytes and scales equal the Pallas kernel's (interpret mode) bit for bit."""
    jx, tx, noise = _quant_inputs(*case)
    jq, js = jops.quantize_int8(jx, jnp.asarray(noise), interpret=True)
    q, s = ops.quantize_int8(tx, torch.from_numpy(noise))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    rq, rs = R.quantize_int8_ref(tx, torch.from_numpy(noise))
    assert torch.equal(q, rq) and torch.equal(s, rs)
    if case[2] == "half":                                # one constant == the full 0.5 tensor
        cq, cs = ops.quantize_int8(tx, 0.5)
        assert torch.equal(cq, q) and torch.equal(cs, s)


def test_quantize_int8_rounds_half_up_at_noise_half():
    # absmax 127 gives scale 1, so x/scale hits the .5 ties exactly
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49]], np.float32)
    q, s = ops.quantize_int8(torch.from_numpy(x), 0.5)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 1, 2, 3, 0, -1, -2, 3]]
    jq, _ = jops.quantize_int8(jnp.asarray(x), jnp.full(x.shape, 0.5, jnp.float32),
                               interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


# ---------------------------------------------------------------------------
# training attention: forward AND gradients against jax.vjp of the JAX ops
# ---------------------------------------------------------------------------

GRAD_CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window
    (2, 24, 24, 4, 4, 16, True, None),      # MHA, causal
    (2, 20, 20, 4, 2, 16, True, 8),         # GQA 2, window 8
    (1, 19, 19, 4, 1, 16, True, None),      # MQA, ragged vs block 16
    (1, 16, 24, 4, 2, 16, False, None),     # not causal, Sq != Skv
]
# forward: reassociation of the online softmax (as ATOL above); gradients:
# both sides differentiate the same plain attention, so only the order of
# float32 sums differs — 1e-4 on O(1) gradients
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4


@pytest.mark.parametrize("op", ["flash_attention", "flash_attention_q8"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=[str(c) for c in GRAD_CASES])
def test_training_attention_forward_and_grads_match_jax(op, case):
    B, Sq, Skv, H, Hkv, D, causal, window = case
    q, k, v = _np((B, Sq, H, D), 21), _np((B, Skv, Hkv, D), 22), _np((B, Skv, Hkv, D), 23)
    g = _np((B, Sq, H, D), 24)
    def fwd(q_, k_, v_):
        return getattr(jops, op)(q_, k_, v_, causal=causal, window=window, block=16,
                                 interpret=True)

    @jax.jit
    def fwd_and_vjp(q_, k_, v_, g_):
        out, vjp = jax.vjp(fwd, q_, k_, v_)
        return out, vjp(g_)

    want, want_grads = fwd_and_vjp(*(jnp.asarray(a) for a in (q, k, v, g)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = getattr(ops, op)(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    _close(got.detach(), want)
    for gp, gj in zip(grads, want_grads):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # on CPU tensors the forward IS the plain version
    with torch.no_grad():
        ref = (R.flash_attention_q8_ref(tq, tk, tv, causal=causal, window=window)
               if op == "flash_attention_q8"
               else R.flash_attention_ref(tq, tk, tv, causal=causal, window=window))
    assert torch.equal(got.detach(), ref)


def test_flash_attention_q8_saves_int8_kv_for_backward():
    """The q8 op's residuals are q plus int8 K/V and their f32 row scales."""
    q, k, v = (torch.from_numpy(_np((2, 12, 4, 16), s)).requires_grad_() for s in (25, 26, 27))
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ops.flash_attention_q8(q, k, v, causal=True)
    assert [t.dtype for t in saved] == [torch.float32, torch.int8, torch.float32,
                                        torch.int8, torch.float32]
    assert [tuple(t.shape) for t in saved] == [(2, 12, 4, 16), (2, 12, 4, 16), (2, 12, 4, 1),
                                               (2, 12, 4, 16), (2, 12, 4, 1)]
