"""The port's recurrent serving path against the JAX package: the plain
versions of the WKV-6 and RG-LRU scans, the attention repairs the hybrid
needs (rotating prefill cache, ``valid_len`` decode), and the rwkv6-7b and
recurrentgemma-2b smoke models (prefill, decode, caches, greedy generate)
with JAX weights carried across by ``params_from_jax``.  The JAX side runs
its Pallas kernels in interpret mode, as tests/test_kernels.py runs them.
Inputs are made with numpy and handed to both packages.

Tolerances and why:
* WKV-6 scan: rtol 1e-5 plus atol 1e-5 of the largest |value|.  The JAX
  kernel runs the chunked log-space form (decays as exp of sums of logs,
  (32, D) products), the plain version one token at a time (products of the
  decays): the two reassociate float32 sums whose terms cancel, so a small
  output can carry the absolute error of a large one (measured: 6.5e-5 on
  outputs of |82|, 9.5e-6 on states of |8|);
* RG-LRU scan: rtol 1e-5, atol 1e-6 (XLA contracts ``a * h + x`` into one
  fused multiply-add; measured 9.5e-7);
* models: as tests/test_torch_models.py (atol 1e-4 on logits and float
  caches, decode logits also rtol 1e-5; int8 bytes within 1 LSB and scales
  rtol 1e-5; greedy tokens identical).  The WKV state is held to atol 1e-3
  and rtol 1e-4: it sums O(10) products of O(10) activations, so the
  models' ~1e-5 relative activation differences reach ~1e-4 in it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ServeSession as JaxServeSession
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ref as JR
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro_torch.api.serving import ServeSession
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as serve_driver
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.train.steps import make_prefill_step, make_serve_step

RECURRENT = ["rwkv6-7b", "recurrentgemma-2b"]
# (arch, kv cache): rwkv6 has no KV cache, recurrentgemma's A layers have both
CASES = [("rwkv6-7b", "native"), ("recurrentgemma-2b", "native"),
         ("recurrentgemma-2b", "int8")]
B, PROMPT, CACHE_LEN, N_DECODE = 2, 20, 30, 4     # prompt > recurrentgemma's window 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _scaled_close(port, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the scans' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


def _wkv_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B_, S, H, D = shape
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal(shape) * 0.5)).astype(np.float32)   # in (0, 1)
    u = rng.standard_normal((H, D)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("shape", [(2, 45, 4, 16), (1, 64, 2, 64)], ids=str)
def test_rwkv6_scan_matches_jax(shape):
    """(2, 45, 4, 16): the smoke head dim with a ragged chunk (45 = 32 + 13);
    (1, 64, 2, 64): the full config's head dim over two whole chunks."""
    args = _wkv_inputs(shape, 0)
    want_out, want_state = jax_rwkv6_scan(*(jnp.asarray(a) for a in args), interpret=True)
    targs = [_t(a) for a in args]
    out, state = ops.rwkv6_scan(*targs)
    assert tuple(out.shape) == shape and out.dtype == torch.float32
    assert tuple(state.shape) == (shape[0], shape[2], shape[3], shape[3])
    _scaled_close(out, want_out)
    _scaled_close(state, want_state)
    # on a CPU tensor the op IS its plain version, which is the JAX oracle's
    ref_out, ref_state = R.rwkv6_scan_ref(*targs)
    assert torch.equal(out, ref_out) and torch.equal(state, ref_state)
    jref_out, jref_state = JR.rwkv6_scan_ref(*(jnp.asarray(a) for a in args))
    _scaled_close(ref_out, jref_out)
    _scaled_close(ref_state, jref_state)


def test_rwkv6_scan_ref_continues_from_a_state():
    """Splitting the sequence and carrying the state gives the whole scan."""
    r, k, v, w, u = (_t(a) for a in _wkv_inputs((1, 40, 2, 16), 1))
    out, state = R.rwkv6_scan_ref(r, k, v, w, u)
    o1, s1 = R.rwkv6_scan_ref(r[:, :17], k[:, :17], v[:, :17], w[:, :17], u)
    o2, s2 = R.rwkv6_scan_ref(r[:, 17:], k[:, 17:], v[:, 17:], w[:, 17:], u, s0=s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2, state, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 45, 300), (1, 130, 256)], ids=str)
def test_rglru_scan_matches_jax(shape):
    """(2, 45, 300): ragged in S and in W against the kernel's 128 x 256
    tiles; (1, 130, 256): past one sequence chunk."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(x), interpret=True)
    got = ops.rglru_scan(_t(a), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert torch.equal(got, R.rglru_scan_ref(_t(a), _t(x)))
    h0 = rng.standard_normal(shape[::2]).astype(np.float32)
    np.testing.assert_allclose(
        R.rglru_scan_ref(_t(a), _t(x), _t(h0)).numpy(),
        np.asarray(JR.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the attention repairs
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(JL.FLAGS, "use_pallas", True)
    monkeypatch.setattr(JL.FLAGS, "pallas_interpret", True)


def _attn_params(seed, d=64, H=2, Hkv=1, D=32):
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, H, D)), "wk": rng.standard_normal((d, Hkv, D)),
         "wv": rng.standard_normal((d, Hkv, D)), "wo": rng.standard_normal((H, D, d))}
    return {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("kv_cache_dtype", ["native", "int8"])
def test_attention_prefill_rotating_keeps_the_last_rows(jax_pallas, kv_cache_dtype):
    """S = 20 > cache_len = 8: the cache holds the last 8 positions at slots
    0-7, as the reference's ``rotating=True`` lays them out."""
    p = _attn_params(3)
    x = np.random.default_rng(4).standard_normal((B, 20, 64)).astype(np.float32)
    kw = dict(cache_len=8, causal=True, window=8, rotating=True, kv_cache_dtype=kv_cache_dtype)
    jo, jc = JL.attention_prefill({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  positions=jnp.arange(20), **kw)
    to, tc = L.attention_prefill({k: _t(v) for k, v in p.items()}, _t(x),
                                 positions=torch.arange(20), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
    assert set(tc) == set(jc)
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape and tc[k].shape[1] == 8
        tol = 1 if tc[k].dtype == torch.int8 else 1e-4
        np.testing.assert_allclose(tc[k].numpy().astype(np.float64),
                                   np.asarray(jc[k]).astype(np.float64), atol=tol, rtol=0)


def test_attention_decode_takes_valid_len(jax_pallas):
    """Rows at or past ``valid_len[b]`` do not attend, whatever the slot."""
    p = _attn_params(5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, 8, 1, 32)).astype(np.float32) for _ in range(2))
    pos, slot, valid = (np.array(a, np.int32) for a in ([30, 5], [7, 5], [8, 6]))
    jo, jc = JL.attention_decode({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                 pos=jnp.asarray(pos), slot=jnp.asarray(slot),
                                 valid_len=jnp.asarray(valid))
    cache = {"k": _t(kc), "v": _t(vc)}
    to, tc = L.attention_decode({k: _t(v) for k, v in p.items()}, _t(x), cache,
                                pos=_t(pos), slot=_t(slot), valid_len=_t(valid))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
    for k in ("k", "v"):
        assert tc[k] is cache[k]
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5)
    # row 1 (valid 6, slot 5) must not see its stale rows 6-7
    stale = {k: v.clone() for k, v in cache.items()}
    stale["k"][1, 6:] = 100.0
    again, _ = L.attention_decode({k: _t(v) for k, v in p.items()}, _t(x), stale,
                                  pos=_t(pos), slot=_t(slot), valid_len=_t(valid))
    assert torch.equal(again[1], to[1])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """JAX weights of the smoke config, every all-zero leaf (the RG-LRU gate
    weights, the decay LoRA's B, norm biases) replaced by small random
    values so that the gates and decays vary -> (JAX tree, port tree)."""
    jparams, _ = jax_get_model(jax_smoke_config(arch)).init_params(key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def fill(a):
        a = np.asarray(a)
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype) if not a.any() else a

    np_tree = jax.tree_util.tree_map(fill, jparams)
    return jax.tree_util.tree_map(jnp.asarray, np_tree), params_from_jax(np_tree, "cpu")


def _models(arch, kv_cache_dtype="native"):
    return (jax_get_model(jax_smoke_config(arch).with_(kv_cache_dtype=kv_cache_dtype)),
            get_model(smoke_config(arch).with_(kv_cache_dtype=kv_cache_dtype)))


def _prompt(seed=0, P=PROMPT):
    return np.random.default_rng(seed).integers(0, 256, (B, P)).astype(np.int32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_cache_close(tc, jc):
    jflat = dict(_flat(jc))
    tflat = dict(_flat(tc))
    assert set(tflat) == set(jflat)
    for path, t in tflat.items():
        j = np.asarray(jflat[path])
        assert tuple(t.shape) == j.shape, path
        if t.dtype == torch.int8:
            assert np.abs(t.numpy().astype(np.int32) - j.astype(np.int32)).max() <= 1, path
        elif path[-1].endswith("_scale"):
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=0, err_msg=str(path))
        elif path[-1] == "wkv":
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-3, err_msg=str(path))
        else:
            np.testing.assert_allclose(t.float().numpy(), j, atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_prefill_and_decode_match_jax(jax_pallas, case):
    arch, kv = case
    jparams, tparams = _weights(arch)
    jm, tm = _models(arch, kv)
    toks = _prompt()
    jl, jc = jm.prefill(jparams, jnp.asarray(toks), CACHE_LEN)
    tl, tc = tm.prefill(tparams, _t(toks).long(), CACHE_LEN)
    assert tuple(tl.shape) == (B, 1, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_cache_close(tc, jc)
    # both decode the JAX package's greedy stream (teacher forcing); for
    # recurrentgemma every step is past the window, so every step rolls
    tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for t in range(N_DECODE):
        pos = jnp.full((B,), PROMPT + t, jnp.int32)
        jl, jc = jm.decode_step(jparams, tok, jc, pos)
        leaf = next(iter(_flat(tc)))[1]
        tl, tc = tm.decode_step(tparams, _t(tok), tc, _t(pos))
        assert next(iter(_flat(tc)))[1] is leaf                  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
        tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_greedy_generate_tokens_match_jax(jax_pallas, case):
    """The reference's own recurrent route: the prompt stepped through
    ``decode_step`` (batch 2, prompt 13 > recurrentgemma's window 8, 6 new
    tokens)."""
    arch, kv = case
    jparams, tparams = _weights(arch)
    jm, tm = _models(arch, kv)
    prompt = _prompt(1, 13)
    want = JaxServeSession(model=jm, params=jparams).generate(
        jnp.asarray(prompt), max_new_tokens=6).tokens
    serve = ServeSession(model=tm, params=tparams, device="cpu")
    assert serve.recurrent
    got = serve.generate(_t(prompt), max_new_tokens=6)
    assert tuple(got.tokens.shape) == (B, 7)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_batched_prefill_state_equals_stepped_prefill_state(case):
    """``make_prefill_step`` (the scan ops) gives the cache that stepping
    ``decode_step`` over the prompt gives, leaf for leaf (atol 1e-3; int8
    bytes within 1 LSB), then ``make_serve_step`` decodes on from it.  With a
    native cache the last logits agree too (atol 1e-3); with an int8 cache
    they do not have to: the batched prefill attends over the prompt's float
    K/V, the stepped one over the int8 cache (as in the reference)."""
    arch, kv = case
    _, tparams = _weights(arch)
    _, tm = _models(arch, kv)
    toks = _t(_prompt(2)).long()
    logits, cache = make_prefill_step(tm, CACHE_LEN)(tparams, toks)
    serve = ServeSession(model=tm, params=tparams, device="cpu")
    step_logits, step_cache = serve._prefill_recurrent(toks, CACHE_LEN)
    if kv == "native":
        np.testing.assert_allclose(logits[:, -1].numpy(), step_logits.numpy(), atol=1e-3)
    for (path, a), (_, b) in zip(_flat(cache), _flat(step_cache)):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype, path
        tol = 1 if a.dtype == torch.int8 else 1e-3
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=tol, rtol=0,
                                   err_msg=str(path))
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    step = make_serve_step(tm)
    for t in range(3):
        tok, out, cache = step(tparams, tok, cache, torch.full((B,), PROMPT + t,
                                                                dtype=torch.int32))
        assert tuple(out.shape) == (B, 1, 256) and torch.isfinite(out).all()


@pytest.mark.parametrize("arch", RECURRENT)
def test_params_carry_across_leaf_for_leaf(arch):
    _, tparams = _weights(arch)
    _, tm = _models(arch)
    abstract, axes = tm.init_params(abstract=True)
    jshapes = jax.eval_shape(
        lambda: jax_get_model(jax_smoke_config(arch)).init_params(key=jax.random.PRNGKey(0))[0])
    jflat = dict(jax.tree_util.tree_flatten_with_path(jshapes)[0])
    assert len(jflat) == len(list(_flat(tparams))) == len(list(_flat(abstract)))
    for path, leaf in jflat.items():
        node, anode, axnode = tparams, abstract, axes
        for key in path:
            node, anode, axnode = node[key.key], anode[key.key], axnode[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(anode.shape)
        assert anode.dtype == node.dtype == torch.float32
        assert len(axnode) == leaf.ndim


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_configs_match_the_reference(arch):
    assert arch in ARCHS
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (smoke_config(arch), jax_smoke_config(arch))):
        for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                      "d_ff", "vocab", "block_pattern", "window", "lru_width", "conv_width",
                      "rwkv_head_dim", "decay_lora", "mlp", "tie_embeddings",
                      "rope_theta"):
            assert getattr(port, field) == getattr(ref, field), field
        assert port.param_count() == ref.param_count()
    full = get_config(arch)
    # abstract init at the published dims: the analytic count plus the norms
    # (and rwkv6's token-shift, decay and group-norm vectors)
    abstract, _ = get_model(full).init_params(abstract=True)
    n = sum(t.numel() for _, t in _flat(abstract))
    assert full.param_count() <= n < 1.01 * full.param_count()


def test_uniform_init_draws_one_layer_slice_at_a_time(monkeypatch):
    """recurrentgemma's ``lam`` (U[2.2, 6.9)) is drawn slice by slice into
    its dtype, as the normal inits are: no float32 draw spans the stack."""
    drawn = []
    real = torch.rand

    def spy(*shape, **kw):
        drawn.append(tuple(shape[0]) if len(shape) == 1 and isinstance(shape[0], tuple)
                     else tuple(shape))
        return real(*shape, **kw)

    monkeypatch.setattr(torch, "rand", spy)
    cfg = smoke_config("recurrentgemma-2b").with_(n_layers=6, dtype=torch.bfloat16)
    params, _ = get_model(cfg).init_params(seed=0, device="cpu")
    lam = params["groups"]["R"]["lru"]["lam"]
    assert lam.dtype == torch.bfloat16 and tuple(lam.shape) == (4, cfg.lru_width)
    assert drawn == [(cfg.lru_width,)] * 4
    assert float(lam.min()) >= 2.2 - 0.02 and float(lam.max()) <= 6.9 + 0.02   # bf16 rounding
    assert not torch.equal(lam[0], lam[1])


def test_only_the_moe_training_forward_raises():
    """The recurrent families train (tests/test_torch_recurrent_train.py);
    the MoE training forward still raises, naming its ROADMAP item."""
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for arch in ARCHS:
        model = get_model(smoke_config(arch))
        params, _ = model.init_params(seed=0, device="cpu")
        if model.cfg.family == "moe":
            with pytest.raises(NotImplementedError, match="ROADMAP item 10, MoE training"):
                model.forward(params, tokens)
        else:
            logits, aux = model.forward(params, tokens)
            assert tuple(logits.shape) == (1, 4, model.cfg.vocab) and float(aux) == 0.0


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_driver_runs_recurrent_on_cpu(capsys, arch):
    rc = serve_driver.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                            "--prompt-len", "10", "--tokens", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "sample token ids" in out
