"""The port's dense serving path against the JAX package on
``smoke_config("deepseek-7b")``, with the JAX weights carried across by
``params_from_jax``.  The JAX side runs its Pallas attention in interpret
mode (``FLAGS.use_pallas=True, pallas_interpret=True``).

Tolerances: both sides compute in float32, but XLA's CPU ``cos``/``sin``/
``rsqrt`` and its reductions differ from PyTorch's in the last bit, and
those ulps grow through two layers to ~1e-4 on O(10) activations.  So logits
and float caches are held to ``atol=1e-4`` (plus ``rtol=1e-5`` on the decode
logits, which reach |10|).  The int8 cache is held bit for
bit where both packages quantize the same float K/V; quantizing K/V that
differ by an ulp can move a value across a rounding tie, so the model-level
int8 bytes are held to 1 LSB and the scales to ``rtol=1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L
from repro_torch.models.api import get_model

ATOL = 1e-4
B, P, CACHE_LEN, N_DECODE = 2, 13, 20, 3


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(JL.FLAGS, "use_pallas", True)
    monkeypatch.setattr(JL.FLAGS, "pallas_interpret", True)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config("deepseek-7b")
    jparams, _ = jax_get_model(jcfg).init_params(key=jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_jax(np_tree, "cpu")


def _models(kv_cache_dtype):
    jm = jax_get_model(jax_smoke_config("deepseek-7b").with_(kv_cache_dtype=kv_cache_dtype))
    tm = get_model(smoke_config("deepseek-7b").with_(kv_cache_dtype=kv_cache_dtype))
    return jm, tm


def _prompt():
    return np.random.default_rng(0).integers(0, 256, (B, P)).astype(np.int32)


def _close(port, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_params_carry_across_leaf_for_leaf(weights):
    jparams, tparams = weights
    _, tm = _models("native")
    abstract, axes = tm.init_params(abstract=True)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    for path, leaf in jflat.items():
        node, anode, axnode = tparams, abstract, axes
        for key in path:
            node, anode, axnode = node[key.key], anode[key.key], axnode[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(anode.shape)
        assert len(axnode) == leaf.ndim
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_prefill_and_decode_match_jax(weights, jax_pallas):
    jparams, tparams = weights
    jm, tm = _models("native")
    toks = _prompt()
    jl, jc = jm.prefill(jparams, jnp.asarray(toks), CACHE_LEN)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks).long(), CACHE_LEN)
    assert tuple(tl.shape) == (B, 1, 256)
    _close(tl, jl)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape == (2, B, CACHE_LEN, 4, 16)
        _close(tc[k], jc[k])
    # both decode the JAX package's greedy stream (teacher forcing)
    tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for t in range(N_DECODE):
        pos = jnp.full((B,), P + t, jnp.int32)
        jl, jc = jm.decode_step(jparams, tok, jc, pos)
        tl, tc = tm.decode_step(tparams, torch.from_numpy(np.array(tok)), tc,
                                torch.from_numpy(np.array(pos)))
        _close(tl, jl, rtol=1e-5)
        tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for k in ("k", "v"):
        _close(tc[k], jc[k])


def test_int8_cache_matches_jax(weights, jax_pallas):
    jparams, tparams = weights
    jm8, tm8 = _models("int8")
    jm, _ = _models("native")
    toks = _prompt()
    jl8, jc8 = jm8.prefill(jparams, jnp.asarray(toks), CACHE_LEN)
    tl8, tc8 = tm8.prefill(tparams, torch.from_numpy(toks).long(), CACHE_LEN)
    # prefill attention runs on full-precision K/V: logits as native
    _, jc = jm.prefill(jparams, jnp.asarray(toks), CACHE_LEN)
    _close(tl8, jl8)
    # the same float K/V cache quantizes bit for bit as in the JAX package,
    # padded rows included (absmax 0 -> scale floor 1e-12, q 0)
    for k in ("k", "v"):
        q, s = R.quantize_int8_ref(torch.from_numpy(np.array(jc[k])))
        jq, js = JR.quantize_int8_ref(jc[k])
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert tc8[k].dtype == torch.int8 and tc8[k + "_scale"].dtype == torch.float32
    _assert_int8_cache_close(tc8, jc8)

    tok = jnp.argmax(jl8[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for t in range(N_DECODE):
        pos = jnp.full((B,), P + t, jnp.int32)
        jl8, jc8 = jm8.decode_step(jparams, tok, jc8, pos)
        tl8, tc8 = tm8.decode_step(tparams, torch.from_numpy(np.array(tok)), tc8,
                                   torch.from_numpy(np.array(pos)))
        _close(tl8, jl8, rtol=1e-5)
        tok = jnp.argmax(jl8[:, -1], axis=-1).astype(jnp.int32)[:, None]
    _assert_int8_cache_close(tc8, jc8)


def _assert_int8_cache_close(tc8, jc8):
    for k in ("k", "v"):
        a, b = tc8[k].numpy().astype(np.int32), np.asarray(jc8[k]).astype(np.int32)
        assert np.abs(a - b).max() <= 1
        assert (a != b).mean() < 0.01
        np.testing.assert_allclose(tc8[k + "_scale"].numpy(), np.asarray(jc8[k + "_scale"]),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("kv_cache_dtype", ["native", "int8"])
def test_attention_decode_writes_each_row_at_its_slot(weights, jax_pallas, kv_cache_dtype):
    """Rows of one batch decode at different positions: each row's new K/V
    lands at its own slot, in place, and nothing else in the cache moves."""
    jparams, tparams = weights
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["attn"])
    tlp = {k: v[0] for k, v in tparams["blocks"]["attn"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    kf = rng.standard_normal((B, CACHE_LEN, 4, 16)).astype(np.float32)
    vf = rng.standard_normal((B, CACHE_LEN, 4, 16)).astype(np.float32)
    slot = np.array([5, 11], np.int32)
    if kv_cache_dtype == "int8":
        kq, ks = JR.quantize_int8_ref(jnp.asarray(kf))
        vq, vs = JR.quantize_int8_ref(jnp.asarray(vf))
        jcache = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    else:
        jcache = {"k": jnp.asarray(kf), "v": jnp.asarray(vf)}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    jo, jc = JL.attention_decode(jlp, jnp.asarray(x), jcache, pos=jnp.asarray(slot),
                                 slot=jnp.asarray(slot))
    to, tc = L.attention_decode(tlp, torch.from_numpy(x), tcache, pos=torch.from_numpy(slot),
                                slot=torch.from_numpy(slot))
    _close(to, jo)
    rows = torch.arange(B)
    for k in tcache:
        assert tc[k] is tcache[k]                         # updated in place
        untouched = torch.ones(tc[k].shape[:2], dtype=torch.bool)
        untouched[rows, torch.from_numpy(slot).long()] = False
        assert torch.equal(tc[k][untouched], before[k][untouched])
        new = tc[k][rows, torch.from_numpy(slot).long()].numpy().astype(np.float64)
        ref = np.asarray(jc[k])[np.arange(B), slot].astype(np.float64)
        tol = 1.0 if tc[k].dtype == torch.int8 else (1e-5 * np.abs(ref).max())
        assert np.abs(new - ref).max() <= tol
