"""The port's encoder-decoder (whisper-medium) and vision-language
(qwen2-vl-7b) families against the JAX package, on their smoke configs, with
one numpy parameter tree handed to both packages
(``tests/test_torch_families.py::numpy_params``).  Both run
through ``Model.prefill(..., frames=/patch_embeds=)`` and
``Model.decode_step``, the route the reference's tests/test_models.py drives
them by; the JAX side runs its plain path (``FLAGS.use_pallas`` off) under
``jax.jit``.

Tolerances (float32 on both sides; XLA's CPU transcendentals and reductions
differ from PyTorch's in the last bit):
* ``sinusoids``: 1e-6 at the smoke length; 2e-4 at whisper's 1500 frames,
  where an ulp of ``exp`` in the timescales grows with the position t before
  the ``sin``/``cos`` (both packages compute t the same way);
* ``apply_mrope``: 1e-6; ``mrope_positions`` and ``mrope_offset``: exact;
* encoder output, logits and float caches: ``atol=1e-4`` (``rtol=1e-5`` on
  decode logits), as the dense families (whisper's logits reach ~48 from
  its tied N(0, 1) embedding; they held to 8e-6 at the prefill);
* int8 caches (whisper's 8 leaves, the VLM's 4): bytes to 1 LSB (at most 1%
  differ) and scales to ``rtol=1e-5``;
* whisper's int8 cross-attention: the reference dequantizes the cross K/V
  and then attends; the port attends the int8 leaves in place, and its plain
  version dequantizes to float32 first: on the CPU the two compute the same
  numbers, so the int8 logits keep the float tolerance;
* greedy tokens: identical to the reference's greedy stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import vlm as JV
from repro.models.api import get_model as jax_get_model
from repro_torch.api.serving import ServeSession
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_driver
from repro_torch.launch import train as train_driver
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import vlm as V
from repro_torch.models.api import get_model
from repro_torch.serve import EngineConfig, ServeEngine
from tests.test_torch_families import assert_int8_cache_close, carried_weights, jax_serving

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

B, P, N_NEW = 2, 12, 6
ATOL = 1e-4
N_PATCH = 4


@pytest.fixture(scope="module")
def weights():
    return {arch: carried_weights(arch) for arch in ("whisper-medium", "qwen2-vl-7b")}


def _close(port, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def _inputs(arch, seed=0):
    """(tokens, numpy side inputs) as tests/test_models.py makes them:
    whisper takes n_frames frames, the VLM a 4-patch prefix."""
    cfg = smoke_config(arch)
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        side = {"frames": rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
        toks = rng.integers(0, cfg.vocab, (B, P))
    else:
        side = {"patch_embeds": rng.standard_normal((B, N_PATCH, cfg.d_model)).astype(np.float32)}
        toks = rng.integers(0, cfg.vocab, (B, P - N_PATCH))
    return toks.astype(np.int32), side


def _j(side):
    return {k: jnp.asarray(v) for k, v in side.items()}


def _t(side):
    return {k: torch.from_numpy(v) for k, v in side.items()}


# ---------------------------------------------------------------------------
# whisper: sinusoids and the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,channels,atol", [(12, 64, 1e-6), (1500, 1024, 2e-4)])
def test_sinusoids_match_jax(length, channels, atol):
    got = E.sinusoids(length, channels)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, channels)
    _close(got, JE.sinusoids(length, channels), atol=atol)


def test_encode_matches_jax(weights):
    jparams, tparams = weights["whisper-medium"]
    _, side = _inputs("whisper-medium")
    want = JE.encode(jparams, jax_smoke_config("whisper-medium"), jnp.asarray(side["frames"]))
    with torch.no_grad():
        got = E.encode(tparams, smoke_config("whisper-medium"), torch.from_numpy(side["frames"]))
    _close(got, want)


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-7b"])
def test_forward_matches_jax(arch, weights):
    jparams, tparams = weights[arch]
    toks, side = _inputs(arch)
    want, _ = jax_get_model(jax_smoke_config(arch)).forward(jparams, jnp.asarray(toks), **_j(side))
    with torch.no_grad():
        got, aux = get_model(smoke_config(arch)).forward(tparams, torch.from_numpy(toks).long(),
                                                         **_t(side))
    assert float(aux) == 0.0 and tuple(got.shape) == (B, P, smoke_config(arch).vocab)
    _close(got, want)


# ---------------------------------------------------------------------------
# prefill, decode and greedy tokens, native and int8
# ---------------------------------------------------------------------------


def _check_cache(tc, jc, kv):
    assert set(tc) == set(jc)
    if kv == "int8":
        int8_names = [k for k in tc if tc[k].dtype == torch.int8]
        assert_int8_cache_close(tc, jc, names=int8_names)
    else:
        for k in tc:
            if k != "mrope_offset":
                _close(tc[k], jc[k])
    if "mrope_offset" in tc:
        np.testing.assert_array_equal(tc["mrope_offset"].numpy(), np.asarray(jc["mrope_offset"]))


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-7b"])
def test_prefill_decode_and_greedy_match_jax(arch, kv, weights):
    """For qwen2-vl-7b with an int8 cache the reference's own
    ``test_int8_kv_cache_greedy_token_parity`` fails on its margin gate
    (``assert 5 >= 6``: one near-tie too few, ROADMAP §3), not on a wrong
    cache; so the port is held to the reference's int8 logits, cache bytes
    and greedy stream directly, never to that gate.

    int8 decode steps run on a copy of the reference's cache bytes, as
    tests/test_torch_families.py's do (a 1-LSB rounding flip moves a logit
    by ~1e-3); the rows they write are held to 1 LSB."""
    jparams, tparams = weights[arch]
    _, jprefill, jdecode = jax_serving(arch, kv)
    tm = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
    toks, side = _inputs(arch)
    start = P                                  # the decoder prompt, or [patches | text]
    cache_len = start + N_NEW + 1
    jl, jc = jprefill(jparams, jnp.asarray(toks), cache_len, **_j(side))
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks).long(), cache_len, **_t(side))
    leaves = {"native": 4, "int8": 8} if arch == "whisper-medium" else {"native": 3, "int8": 5}
    assert len(tc) == leaves[kv]
    _close(tl, jl)
    _check_cache(tc, jc, kv)
    tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    stream = [np.asarray(tok)]
    for t in range(N_NEW):
        pos = jnp.full((B,), start + t, jnp.int32)
        if kv == "int8":
            tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        jl, jc = jdecode(jparams, tok, jc, pos)
        tl, tc = tm.decode_step(tparams, torch.from_numpy(np.array(tok)), tc,
                                torch.from_numpy(np.array(pos)))
        _close(tl, jl, rtol=1e-5)
        tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
        stream.append(np.asarray(tok))
    _check_cache(tc, jc, kv)
    got = ServeSession(model=tm, params=tparams, device="cpu").generate(
        torch.from_numpy(toks).long(), max_new_tokens=N_NEW, **_t(side)).tokens   # cache_len
    np.testing.assert_array_equal(got.numpy(), np.concatenate(stream, axis=1))


def test_whisper_int8_cache_quantizes_the_cross_kv(weights):
    """The 8-leaf int8 cache: cross K/V bytes and scales are the reference
    quantizer's over the float cross K/V of the native cache."""
    jparams, tparams = weights["whisper-medium"]
    toks, side = _inputs("whisper-medium")
    m8 = get_model(smoke_config("whisper-medium").with_(kv_cache_dtype="int8"))
    m = get_model(smoke_config("whisper-medium"))
    _, c8 = m8.prefill(tparams, torch.from_numpy(toks).long(), 20, **_t(side))
    _, c = m.prefill(tparams, torch.from_numpy(toks).long(), 20, **_t(side))
    assert sorted(c8) == sorted(["k", "k_scale", "v", "v_scale",
                                 "xk", "xk_scale", "xv", "xv_scale"])
    cfg = m.cfg
    assert tuple(c8["xk"].shape) == (cfg.n_dec_layers, B, cfg.n_frames, cfg.n_kv_heads, 16)
    assert tuple(c8["xk_scale"].shape) == (cfg.n_dec_layers, B, cfg.n_frames, cfg.n_kv_heads, 1)
    from repro.kernels import ref as JR
    for name in ("xk", "xv"):
        jq, js = JR.quantize_int8_ref(jnp.asarray(c[name].numpy()))
        np.testing.assert_array_equal(c8[name].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(c8[name + "_scale"].numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

MROPE_CASES = [(2, 12, None, None), (1, 9, 4, None), (3, 20, 9, 3), (2, 7, 0, None),
               (2, 30, 16, 5)]


@pytest.mark.parametrize("case", MROPE_CASES, ids=[str(c) for c in MROPE_CASES])
def test_mrope_positions_exact(case):
    batch, seq, n_vis, grid = case
    cfg = smoke_config("qwen2-vl-7b")
    got = V.mrope_positions(cfg, batch, seq, grid=grid, n_vis=n_vis)
    want = JV.mrope_positions(jax_smoke_config("qwen2-vl-7b"), batch, seq, grid=grid,
                              n_vis=n_vis)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sections,D", [((4, 2, 2), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, D):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 3, D)).astype(np.float32)
    pos = np.asarray(JV.mrope_positions(jax_smoke_config("qwen2-vl-7b"), 2, 9, n_vis=4))
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos.copy()), sections, 1e6)
    _close(got, want, atol=1e-6)
    with pytest.raises(ValueError):
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos.copy()), (1, 1, 1), 1e6)


@pytest.mark.parametrize("with_patches", [True, False])
def test_vlm_mrope_offset_matches_jax(with_patches, weights):
    """``prefill`` writes the text positions' offset into the cache, with a
    patch prefix and on ``generate``'s text-only route."""
    jparams, tparams = weights["qwen2-vl-7b"]
    toks, side = _inputs("qwen2-vl-7b")
    if not with_patches:
        side = {}
    _, jc = jax_get_model(jax_smoke_config("qwen2-vl-7b")).prefill(
        jparams, jnp.asarray(toks), 16, **_j(side))
    _, tc = get_model(smoke_config("qwen2-vl-7b")).prefill(
        tparams, torch.from_numpy(toks).long(), 16, **_t(side))
    assert tc["mrope_offset"].dtype == torch.int32
    np.testing.assert_array_equal(tc["mrope_offset"].numpy(), np.asarray(jc["mrope_offset"]))


def test_vlm_generate_is_the_text_only_route(weights):
    jparams, tparams = weights["qwen2-vl-7b"]
    toks, _ = _inputs("qwen2-vl-7b")
    _, jprefill, jdecode = jax_serving("qwen2-vl-7b", "native")
    cache_len = toks.shape[1] + N_NEW + 1
    jl, jc = jprefill(jparams, jnp.asarray(toks), cache_len)
    tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    stream = [np.asarray(tok)]
    for t in range(N_NEW):
        jl, jc = jdecode(jparams, tok, jc, jnp.full((B,), toks.shape[1] + t, jnp.int32))
        tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
        stream.append(np.asarray(tok))
    got = ServeSession(model=get_model(smoke_config("qwen2-vl-7b")), params=tparams,
                       device="cpu").generate(torch.from_numpy(toks), max_new_tokens=N_NEW).tokens
    np.testing.assert_array_equal(got.numpy(), np.concatenate(stream, axis=1))


# ---------------------------------------------------------------------------
# what decode_step writes, and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-7b"])
def test_decode_writes_cover_what_decode_step_writes(arch, kv, weights):
    """Everything ``decode_step`` changes lies at the indices ``decode_writes``
    names (the self K/V rows at ``pos``); the cross K/V and ``mrope_offset``
    are only read."""
    _, tparams = weights[arch]
    model = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
    toks, side = _inputs(arch)
    _, cache = model.prefill(tparams, torch.from_numpy(toks).long(), P + 4, **_t(side))
    before = {k: v.clone() for k, v in cache.items()}
    pos = [P, P + 2]
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    model.decode_step(tparams, tok, cache, torch.tensor(pos, dtype=torch.int32))
    writes = model.decode_writes(cache, pos, [0, 1])
    written = {id(leaf) for leaf, _ in writes}
    for name, leaf in cache.items():
        if name.startswith("x") or name == "mrope_offset":
            assert id(leaf) not in written
        restored = leaf.clone()
        for w_leaf, at in writes:
            if w_leaf is leaf:
                restored[at] = before[name][at]
        assert torch.equal(restored, before[name]), name
    assert any(not torch.equal(cache[k], before[k]) for k in ("k", "v"))


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-7b"])
def test_engine_refuses_encdec_and_vlm(arch, weights):
    with pytest.raises(NotImplementedError):
        ServeEngine(model=get_model(smoke_config(arch)), params=weights[arch][1], device="cpu",
                    config=EngineConfig(max_slots=2, max_len=32, block_size=4, num_blocks=16,
                                        prefill_chunk=8, token_budget=16))


def test_generate_on_encdec_raises_a_named_error(weights):
    session = ServeSession(model=get_model(smoke_config("whisper-medium")),
                           params=weights["whisper-medium"][1], device="cpu")
    with pytest.raises(ValueError, match="frames"):
        session.generate(torch.zeros((B, 4), dtype=torch.long), max_new_tokens=2)


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-7b"])
def test_train_driver_refuses_encdec_and_vlm(capsys, arch):
    """The training driver refuses whisper, whose encoder needs frames the
    fleet's batches do not carry, with an error naming them; qwen2-vl trains
    text-only, as the reference's launcher does."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "2", "--seq", "16"]
    if arch == "whisper-medium":
        with pytest.raises(SystemExit):
            train_driver.main(argv)
        assert "frames" in capsys.readouterr().err
    else:
        assert train_driver.main(argv) == 0
        out = capsys.readouterr().out
        assert f"arch={arch}" in out and "2 steps in" in out


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-7b"])
def test_serve_driver_runs_on_cpu(capsys, arch):
    assert serve_driver.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                              "--prompt-len", "10", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "sample token ids" in out
