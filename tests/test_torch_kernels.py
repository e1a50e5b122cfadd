"""repro_torch.kernels.ops on CPU tensors (the plain PyTorch versions) against
the JAX package's ops, run in Pallas interpret mode as tests/test_kernels.py
runs them.  Inputs are made once with numpy and handed to both packages.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each of them to these plain versions there.
"""
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
