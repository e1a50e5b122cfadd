"""The port's dense families against the JAX package: qwen1.5-4b (QKV bias),
minitron-8b (squared-ReLU MLP) and deepseek-coder-33b (GQA group 7 at full
width; 4 heads over 2 in the smoke config), on their smoke configs, with
one numpy parameter tree in the reference's layout handed to both packages
(``params_from_jax`` on the port's side).  The JAX side runs its plain path
(``FLAGS.use_pallas`` off, the default) under ``jax.jit``, which keeps this
file cheap; the Pallas kernels' parity is tests/test_torch_kernels.py's.

The tree is drawn with numpy (``numpy_params``), not by the reference's
``init_params`` (``jax.random`` leaf by leaf costs ~3 s an arch on one
core), and its biases are drawn too: both packages initialize them at zero,
and a bias left at zero would test nothing.

Tolerances: both sides compute in float32, but XLA's CPU ``cos``/``sin``/
``rsqrt`` and its reductions differ from PyTorch's in the last bit (ROADMAP
§3, "K/V ulps"), so logits and float caches are held to ``atol=1e-4`` (and
``rtol=1e-5`` on decode logits), layer outputs to ``atol=1e-5``; int8 cache
bytes to 1 LSB (at most 1% of them differ) and scales to ``rtol=1e-5``, as
tests/test_torch_models.py holds deepseek-7b's, and int8 decode steps run on
a copy of the reference's cache bytes (the test says why); greedy tokens
identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro.models.param import build as jax_build
from repro.optim import sgd_momentum as jax_sgd
from repro.train import steps as JS
from repro_torch.api.serving import ServeSession
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as serve_driver
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.models.param import build
from repro_torch.optim import sgd_momentum
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train import steps as S

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

DENSE = ["qwen1.5-4b", "minitron-8b", "deepseek-coder-33b"]
B, P, CACHE_LEN, N_NEW = 2, 13, 20, 6
ATOL = 1e-4
BIASES = ("bq", "bk", "bv", "bi", "bo")


def with_random_biases(tree, seed):
    """The numpy tree with every bias leaf drawn from N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (0.1 * rng.standard_normal(v.shape)).astype(v.dtype) if k in BIASES
                    else np.asarray(v))
                for k, v in node.items()}

    return walk(tree)


def numpy_params(arch, seed=0):
    """A float32 parameter tree of ``arch``'s smoke config with the leaves of
    the reference's abstract init, drawn with numpy: norm scales 1; biases,
    LayerNorm shifts and whisper's position table N(0, 0.1^2); embedding
    tables N(0, 1); every projection of the stacked blocks N(0, 1/fan_in)
    over the axes it contracts (an attention ``wo`` (L, H, hd, d) over H and
    hd, every other over its second axis)."""
    abstract, _ = jax_get_model(jax_smoke_config(arch)).init_params(abstract=True)
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "scale":
            return np.ones(shape)
        if name in BIASES + ("bias", "dec_pos"):
            return 0.1 * rng.standard_normal(shape)
        if name == "table":
            return rng.standard_normal(shape)
        fan_in = shape[1] * (shape[2] if name == "wo" and len(shape) == 4 else 1)
        return rng.standard_normal(shape) / np.sqrt(fan_in)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v.shape).astype(np.float32)
                for k, v in node.items()}

    return walk(abstract)


def carried_weights(arch, seed=0):
    """(JAX params, port params) of ``arch``'s smoke config, from one numpy tree."""
    np_tree = numpy_params(arch, seed)
    return jax.tree_util.tree_map(jnp.asarray, np_tree), params_from_jax(np_tree, "cpu")


@functools.lru_cache(maxsize=None)
def jax_serving(arch, kv):
    """The reference's smoke model with ``kv`` cache and its jitted prefill
    (``cache_len`` static) and decode step."""
    jm = jax_get_model(jax_smoke_config(arch).with_(kv_cache_dtype=kv))
    return jm, jax.jit(jm.prefill, static_argnums=2), jax.jit(jm.decode_step)


@pytest.fixture(scope="module")
def weights():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = carried_weights(arch)
        return memo[arch]

    return get


def _close(port, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_int8_cache_close(tc, jc, names=("k", "v")):
    for k in names:
        a, b = tc[k].numpy().astype(np.int32), np.asarray(jc[k]).astype(np.int32)
        assert tc[k].dtype == torch.int8
        assert np.abs(a - b).max() <= 1
        assert (a != b).mean() < 0.01
        np.testing.assert_allclose(tc[k + "_scale"].numpy(), np.asarray(jc[k + "_scale"]),
                                   rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

# the reference's modality and norm labels are read by none of its models and
# have no counterpart in the port
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
          "d_ff", "vocab", "qkv_bias", "rope_theta", "mlp", "tie_embeddings",
          "n_enc_layers", "n_dec_layers", "n_frames", "mrope_sections", "n_vision_patches")


def test_archs_are_the_references():
    from repro.configs import ARCHS as JAX_ARCHS
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("arch", DENSE + ["whisper-medium", "qwen2-vl-7b"])
def test_new_configs_match_the_reference(arch):
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (smoke_config(arch), jax_smoke_config(arch))):
        for field in FIELDS:
            assert getattr(port, field) == getattr(ref, field), field
        assert port.param_count() == ref.param_count()
    # the abstract trees at the published dims: the same leaves and shapes
    port_tree, _ = get_model(get_config(arch)).init_params(abstract=True)
    ref_tree, _ = jax_get_model(jax_get_config(arch)).init_params(abstract=True)
    ref_flat = {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf in
                jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert {path: tuple(t.shape) for path, t in _flat(port_tree)} == ref_flat


# ---------------------------------------------------------------------------
# layers: the MLP kinds and QKV-bias attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["relu2", "gelu", "swiglu", "geglu"])
def test_mlp_kinds_match_jax(kind):
    d, ff = 32, 48
    jtree, _ = jax_build(lambda b: JL.init_mlp(b, "mlp", kind, d, ff),
                         key=jax.random.PRNGKey(3))
    ttree, _ = build(lambda b: L.init_mlp(b, "mlp", kind, d, ff), seed=0)
    np_tree = with_random_biases(jax.tree_util.tree_map(np.asarray, jtree), 4)["mlp"]
    assert {k: v.shape for k, v in np_tree.items()} == \
        {k: tuple(v.shape) for k, v in ttree["mlp"].items()}
    assert ("bi" in np_tree) == (kind == "gelu")
    x = np.random.default_rng(5).standard_normal((2, 7, d)).astype(np.float32)
    want = JL.mlp_apply(jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(x), kind)
    got = L.mlp_apply(params_from_jax(np_tree, "cpu"), torch.from_numpy(x), kind)
    _close(got, want, atol=1e-5)


def _attention_weights(bias, d=64, H=4, Hkv=2, hd=16, seed=6):
    jtree, _ = jax_build(lambda b: JL.init_attention(b, "attn", d, H, Hkv, hd, qkv_bias=bias),
                         key=jax.random.PRNGKey(seed))
    np_tree = with_random_biases(jax.tree_util.tree_map(np.asarray, jtree), seed)["attn"]
    return jax.tree_util.tree_map(jnp.asarray, np_tree), params_from_jax(np_tree, "cpu")


@pytest.mark.parametrize("use_rope", [True, False])
def test_qkv_bias_attention_matches_jax(use_rope):
    jp, tp = _attention_weights(True)
    assert set(tp) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 9, 64)).astype(np.float32)
    pos = np.arange(9)
    kw = dict(use_rope=use_rope, rope_theta=1e6)
    tkw = dict(positions=torch.from_numpy(pos), use_rope=use_rope, rope_theta=1e6)
    # the reference's layers under jit: one compile each, not one an op
    jtrain = jax.jit(lambda p_, x_, s_: JL.attention_train(p_, x_, positions=s_, **kw))
    jprefill = jax.jit(lambda p_, x_, s_: JL.attention_prefill(p_, x_, positions=s_,
                                                               cache_len=12, **kw))
    jdecode = jax.jit(lambda p_, x_, c_, s_: JL.attention_decode(p_, x_, c_, pos=s_, **kw))
    _close(L.attention_train(tp, torch.from_numpy(x), **tkw),
           jtrain(jp, jnp.asarray(x), jnp.asarray(pos)), atol=1e-5)
    jo, jc = jprefill(jp, jnp.asarray(x), jnp.asarray(pos))
    to, tc = L.attention_prefill(tp, torch.from_numpy(x), cache_len=12, **tkw)
    _close(to, jo, atol=1e-5)
    for k in ("k", "v"):
        _close(tc[k], jc[k], atol=1e-5)
    # one decode step at rows 9 and 5 of the prefilled cache
    xd = rng.standard_normal((B, 1, 64)).astype(np.float32)
    pos_d = np.array([9, 5], np.int32)
    jo, jc = jdecode(jp, jnp.asarray(xd), jc, jnp.asarray(pos_d))
    to, tc = L.attention_decode(tp, torch.from_numpy(xd), tc, pos=torch.from_numpy(pos_d),
                                use_rope=use_rope, rope_theta=1e6)
    _close(to, jo, atol=1e-5)
    for k in ("k", "v"):
        _close(tc[k], jc[k], atol=1e-5)


def test_cross_kv_and_cross_attention_match_jax():
    jp, tp = _attention_weights(True, H=4, Hkv=4)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 5, 64)).astype(np.float32)       # decoder rows
    ctx = rng.standard_normal((B, 11, 64)).astype(np.float32)    # encoder output
    jk, jv = JL.cross_kv(jp, jnp.asarray(ctx))
    tk, tv = L.cross_kv(tp, torch.from_numpy(ctx))
    _close(tk, jk, atol=1e-5)
    _close(tv, jv, atol=1e-5)
    want = JL.cross_attention(jp, jnp.asarray(x), jk, jv)
    _close(L.cross_attention(tp, torch.from_numpy(x), tk, tv), want, atol=1e-5)
    # one row through the decode op, over every frame, native and int8
    got = L.cross_attention_decode(tp, torch.from_numpy(x[:, :1]), {"xk": tk, "xv": tv})
    _close(got, np.asarray(want)[:, :1], atol=1e-5)


# ---------------------------------------------------------------------------
# the three dense configs: prefill, decode and greedy tokens
# ---------------------------------------------------------------------------


def _prompt(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(np.int32)


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_decode_and_greedy_match_jax(arch, kv, weights):
    jparams, tparams = weights(arch)
    jm, jprefill, jdecode = jax_serving(arch, kv)
    tm = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
    toks = _prompt(jm.cfg.vocab)
    jl, jc = jprefill(jparams, jnp.asarray(toks), CACHE_LEN)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks).long(), CACHE_LEN)
    assert tuple(tl.shape) == (B, 1, jm.cfg.vocab)
    _close(tl, jl)
    check_cache = (lambda: assert_int8_cache_close(tc, jc)) if kv == "int8" else \
        (lambda: [_close(tc[k], jc[k]) for k in ("k", "v")])
    check_cache()
    # both decode the JAX package's greedy stream (teacher forcing); that
    # stream is also the reference's greedy output, which generate must give.
    # An int8 step runs on a copy of the reference's cache bytes: float K/V
    # an ulp apart can round a row to a neighbouring int8 value (the caches
    # hold to 1 LSB), which moved a logit by 1.7e-3 on minitron-8b's smoke
    # config, so the step is held on equal bytes, where its logits keep the
    # float tolerance
    tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    stream = [np.asarray(tok)]
    for t in range(N_NEW):
        pos = jnp.full((B,), P + t, jnp.int32)
        if kv == "int8":
            tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        jl, jc = jdecode(jparams, tok, jc, pos)
        tl, tc = tm.decode_step(tparams, torch.from_numpy(np.array(tok)), tc,
                                torch.from_numpy(np.array(pos)))
        _close(tl, jl, rtol=1e-5)
        tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
        stream.append(np.asarray(tok))
    check_cache()
    got = ServeSession(model=tm, params=tparams, device="cpu").generate(
        torch.from_numpy(toks), max_new_tokens=N_NEW, cache_len=CACHE_LEN).tokens
    np.testing.assert_array_equal(got.numpy(), np.concatenate(stream, axis=1))


# ---------------------------------------------------------------------------
# training: 3 steps against jit(make_train_step)
# ---------------------------------------------------------------------------

# SGD with momentum, whose update is linear in the gradient, so the params
# after 3 steps hold every gradient (AdamW divides a near-zero gradient, such
# as the key bias's, by its own square root and turns float noise into
# +-lr steps).  loss rtol 1e-5: f32 ulps through two layers; grad norm rtol
# 1e-4 (tests/test_torch_train.py measures 1.8e-5 at a first step); params,
# biases and the relu2 MLP's wi/wo included, atol 1e-4, as
# tests/test_torch_train.py holds deepseek-7b's.  Each leaf's first-step
# gradient within 1e-5 of the leaf's largest |gradient| (measured: at most
# 1.6e-6, f32 reassociation).
STEPS, LR = 3, 1e-2
GRAD_SHARE = 1e-5


def _batch(vocab, rows=4, seq=16, seed=7):
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1)).astype(np.int32)
    mask = np.ones((rows, seq), np.float32)
    mask[-1, seq // 2:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _leaves_by_path(tree):
    return {tuple(k.key for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minitron-8b"])
def test_train_trajectory_matches_jax_train_step(arch, weights):
    """3 steps of the port's ``make_train_step`` against the reference's under
    ``jax.jit``; at the first step every leaf's gradient too (the reference's
    ``value_and_grad`` of its ``loss_fn``, jitted with its step: one
    compile)."""
    jparams, _ = weights(arch)
    cfg = jax_smoke_config(arch)
    jmodel, jopt, topt = jax_get_model(cfg), jax_sgd(), sgd_momentum()
    jtrain = JS.make_train_step(jmodel, jopt, lambda s: jnp.float32(LR))

    @jax.jit
    def jstep(p, s, b):
        grads = jax.grad(lambda p_: JS.loss_fn(jmodel, p_, b)[0])(p)
        return jtrain(p, s, b), grads

    model = get_model(smoke_config(arch))
    tstep = S.make_train_step(model, topt, lambda s: torch.tensor(LR, dtype=torch.float32))
    jp, js = jparams, jopt.init(jparams)
    # a fresh copy: the port's optimizer updates params in place
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    ts = topt.init(tp)
    for i in range(STEPS):
        b = _batch(cfg.vocab, seed=7 + i)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        if i == 0:
            _, tgrads = S.value_and_grad(model, tp, tb)
        (jp, js, jm), jgrads = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        if i == 0:
            jflat, tflat = _leaves_by_path(jgrads), dict(_flat(tgrads))
            assert set(tflat) == set(jflat)
            for path, g in tflat.items():
                want = jflat[path]
                assert np.abs(want).max() > 0, path
                np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                           atol=GRAD_SHARE * np.abs(want).max(),
                                           err_msg=str(path))
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    jflat, tflat = _leaves_by_path(jp), dict(_flat(tp))
    assert set(tflat) == set(jflat)
    trained = [p for p in tflat if p[-1] in BIASES or (arch == "minitron-8b" and p[-2] == "mlp")]
    assert trained
    for path, leaf in tflat.items():
        np.testing.assert_allclose(leaf.numpy(), jflat[path], atol=1e-4, err_msg=str(path))


# ---------------------------------------------------------------------------
# the engine and the serve driver
# ---------------------------------------------------------------------------


def test_engine_greedy_equals_generate_on_qwen15(weights):
    _, tparams = weights("qwen1.5-4b")
    model = get_model(smoke_config("qwen1.5-4b"))
    prompts = np.random.default_rng(1).integers(0, model.cfg.vocab, (3, 11)).astype(np.int32)
    engine = ServeEngine(model=model, params=tparams, device="cpu",
                         config=EngineConfig(max_slots=2, max_len=48, block_size=4,
                                             num_blocks=32, prefill_chunk=8, token_budget=16))
    outs = engine.generate_batch([p.tolist() for p in prompts], max_new_tokens=N_NEW + 1)
    oracle = ServeSession(model=model, params=tparams, device="cpu").generate(
        torch.from_numpy(prompts), max_new_tokens=N_NEW).tokens
    assert [o.tokens for o in outs] == oracle.tolist()


@pytest.mark.parametrize("arch", DENSE)
def test_serve_driver_runs_dense_families_on_cpu(capsys, arch):
    assert serve_driver.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                              "--prompt-len", "10", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "sample token ids" in out
