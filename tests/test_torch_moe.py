"""The port's MoE path against the JAX package: routing, the plain versions
of the two MoE kernels, the differentiable op, and the MoE models on
``smoke_config("qwen3-moe-30b-a3b")`` and ``smoke_config("dbrx-132b")`` with
JAX weights carried across by ``params_from_jax``.  The JAX side runs its
Pallas kernels in interpret mode, as tests/test_kernels.py runs them.
Inputs are made with numpy and handed to both packages.

Tolerances and why:
* routing: slot tables bit-equal (integer ops on the same top-k); gates and
  aux at rtol 1e-5: the router matmul's f32 reassociation moves logits of
  O(10) by ~2e-6, and a gate's relative error follows its logits' absolute
  error (measured up to 1.5e-6);
* expert GEMM in f32: atol/rtol 1e-5 (f32 reassociation over d and f); in
  bf16 rtol 2**-8, within one bf16 ulp of each output (both sides compute
  the same f32 value up to reassociation, then round once);
* combine: bit-equal in f32 to ``_combine_xla``, the sequential scatter-add
  whose fixed order the reference promises (both add each token's <= k
  rows in ascending slot order).  Bit-equal to the JAX kernel (a one-hot
  contraction) wherever no token keeps more than two rows; with three or
  more, XLA's dot adds them in another order (the JAX kernel then differs
  from ``_combine_xla`` too), so there the kernel is held to f32
  reassociation of <= k terms, atol/rtol 1e-6;
* op forward 2e-5 and gradients 2e-4, as tests/test_kernels.py holds the
  JAX op to its oracle;
* models: as tests/test_torch_models.py (atol 1e-4 on logits and caches,
  int8 bytes within 1 LSB, greedy tokens identical).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ServeSession as JaxServeSession
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import fused_moe as JFM
from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models.api import get_model as jax_get_model
from repro_torch.api.serving import ServeSession
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import fused_moe as FM
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as serve_driver
from repro_torch.models import moe as M
from repro_torch.models import param as P
from repro_torch.models.api import get_model

MOE_ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_inputs(seed, T, d, f, E, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wo = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    return x.astype(dtype), router, wg.astype(dtype), wu.astype(dtype), wo.astype(dtype)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTING_CASES = [
    # T, d, E, k, C
    (64, 32, 8, 2, 32),            # no drops
    (128, 32, 8, 2, 8),            # heavy overflow: 64 slots, 256 copies
    (96, 16, 8, 1, 8),             # top-1
    (100, 48, 4, 4, 16),           # ragged T, every expert picked per token
]


@pytest.mark.parametrize("case", ROUTING_CASES, ids=[str(c) for c in ROUTING_CASES])
def test_moe_routing_matches_jax(case):
    T, d, E, k, C = case
    x, router, *_ = _moe_inputs(1, T, d, 8, E)
    want = JFM.moe_routing(jnp.asarray(x), jnp.asarray(router), k, C)
    got = FM.moe_routing(_t(x), _t(router), k, C)
    for name, g, w in zip(("slot_tok", "st", "slot", "keep"),
                          (got[0], got[2], got[3], got[4]),
                          (want[0], want[2], want[3], want[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-5)
    if C * E < T * k:
        assert not bool(got[4].all())                 # the overflow case drops copies


# ---------------------------------------------------------------------------
# the two kernels' plain versions, fed JAX's own slot tables
# ---------------------------------------------------------------------------

GEMM_CASES = [
    # T, d, f, E, k, C, dtype
    (64, 32, 64, 8, 2, 32, "float32"),
    (128, 32, 64, 8, 2, 8, "float32"),          # overflow
    (256, 64, 128, 16, 4, 256, "float32"),      # two capacity blocks per expert
    (100, 48, 96, 4, 2, 64, "float32"),         # ragged T; dbrx smoke's f
    (64, 32, 64, 8, 2, 32, "bfloat16"),
]


def _jax_tables(x, router, k, C):
    st = JFM.moe_routing(jnp.asarray(x, jnp.float32), jnp.asarray(router), k, C)
    return st[0], st[1]


@pytest.mark.parametrize("case", GEMM_CASES, ids=[str(c) for c in GEMM_CASES])
def test_fused_moe_gemm_ref_matches_jax_kernel(case):
    T, d, f, E, k, C, dt = case
    x, router, wg, wu, wo = _moe_inputs(2, T, d, f, E)
    slot_tok, slot_gate = _jax_tables(x, router, k, C)
    jdt = jnp.dtype(dt)
    jx, jwg, jwu, jwo = (jnp.asarray(a, jdt) for a in (x, wg, wu, wo))
    want = JFM.fused_moe_gemm(jx, jwg, jwu, jwo, slot_tok, slot_gate, interpret=True)
    tdt = getattr(torch, dt)
    tx, twg, twu, two = (_t(np.asarray(a, np.float32)).to(tdt) for a in (jx, jwg, jwu, jwo))
    got = R.fused_moe_gemm_ref(tx, twg, twu, two, _t(slot_tok), _t(slot_gate))
    assert got.dtype == tdt and tuple(got.shape) == (E * C, d)
    want = np.asarray(want, np.float32)
    if dt == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=2.0 ** -8)
    empty = np.asarray(slot_tok)[:, 0] == T
    assert not got.float().numpy()[empty].any()                   # empty slots give 0
    # on a CPU tensor the op IS its plain version
    assert torch.equal(ops.fused_moe_gemm(tx, twg, twu, two, _t(slot_tok), _t(slot_gate)), got)


COMBINE_CASES = [
    # T, d, E, k, C
    (64, 32, 8, 2, 32),            # no drops
    (64, 32, 8, 2, 8),             # moderate overflow
    (64, 32, 8, 4, 4),             # heavy overflow: most copies dropped
    (100, 48, 4, 1, 16),           # ragged T against the kernel's block of 128
    (200, 16, 8, 2, 16),           # ragged T over two token blocks, overflow
    (200, 16, 8, 4, 128),          # ragged T over two token blocks, k = 4
]


@pytest.mark.parametrize("case", COMBINE_CASES, ids=[str(c) for c in COMBINE_CASES])
def test_fused_moe_combine_ref_bit_equal_to_jax(case):
    T, d, E, k, C = case
    x, router, *_ = _moe_inputs(3, T, d, 8, E)
    slot_tok, _, st, slot, keep, _ = JFM.moe_routing(jnp.asarray(x), jnp.asarray(router), k, C)
    y = np.random.default_rng(4).standard_normal((E * C, d)).astype(np.float32)
    live = np.asarray(slot_tok)[:, 0] < T
    # the kernel's input has gate-zeroed empty slots; the combine must not
    # read them at all
    y[~live] = 0.0
    got = R.fused_moe_combine_ref(_t(y), _t(slot_tok), T)
    assert tuple(got.shape) == (T, d)
    xla = JFM._combine_xla(jnp.asarray(y), st, slot, keep, T, E, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    want = np.asarray(JFM.fused_moe_combine(jnp.asarray(y), slot_tok, T, interpret=True))
    if np.bincount(np.asarray(slot_tok)[live, 0], minlength=T).max() <= 2:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    assert torch.equal(ops.fused_moe_combine(_t(y), _t(slot_tok), T), got)


def test_fused_moe_combine_ref_ignores_empty_slot_rows_and_rounds_once():
    """Empty slots (token T) are never added, and a bf16 sum is taken in f32
    and rounded once (the Pallas kernel's numerics, not _combine_xla's)."""
    T, d = 3, 8
    slot_tok = torch.tensor([[2], [3], [0], [2], [3], [2]], dtype=torch.int32)
    y = torch.full((6, d), 1.0)
    y[1] = y[4] = float("nan")                          # empty slots: never read
    y[0], y[3], y[5] = 1.0, 2.0 ** -8, 2.0 ** -8
    out = R.fused_moe_combine_ref(y.to(torch.bfloat16), slot_tok, T)
    assert out.dtype == torch.bfloat16
    assert out[0].float().eq(1.0).all() and out[1].float().eq(0.0).all()
    # 1 + 2^-8 + 2^-8 = 1 + 2^-7 in f32, a bf16 value; rounding after each
    # bf16 add would lose both halves (1 + 2^-8 ties to 1)
    assert out[2].float().eq(1.0 + 2.0 ** -7).all()


# ---------------------------------------------------------------------------
# the differentiable op and its oracle
# ---------------------------------------------------------------------------

OP_CASES = [
    # T, d, f, E, k, C
    (64, 32, 64, 8, 2, 32),
    (128, 32, 64, 4, 2, 8),        # overflow: 256 copies, 32 slots
    (96, 8, 16, 8, 1, 8),          # top-1
]


@pytest.mark.parametrize("case", OP_CASES, ids=[str(c) for c in OP_CASES])
def test_fused_moe_mlp_op_and_oracle_match_jax(case):
    T, d, f, E, k, C = case
    args = _moe_inputs(5, T, d, f, E)
    jargs = tuple(jnp.asarray(a) for a in args)
    want, want_aux = jops.fused_moe_mlp(*jargs, k=k, capacity=C, interpret=True)
    got, aux = ops.fused_moe_mlp(*(_t(a) for a in args), k=k, capacity=C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    ref, ref_aux = R.fused_moe_mlp_ref(*(_t(a) for a in args), k, C)
    jref, jref_aux = JR.fused_moe_mlp_ref(*jargs, k=k, capacity=C)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(ref_aux), float(jref_aux), rtol=1e-5)


def test_fused_moe_mlp_goes_through_its_counted_parts(monkeypatch):
    """The MoE layer op keeps no launch counter of its own; each of the ops
    ``ops.COMPOSITE_OPS`` lists for it runs once per call."""
    calls = []
    for part in ops.COMPOSITE_OPS["fused_moe_mlp"]:
        real = getattr(ops, part)
        monkeypatch.setattr(ops, part,
                            lambda *a, _p=part, _f=real, **kw: calls.append(_p) or _f(*a, **kw))
    args = _moe_inputs(5, 64, 32, 64, 8)
    ops.fused_moe_mlp(*(_t(a) for a in args), k=2, capacity=32)
    assert sorted(calls) == sorted(ops.COMPOSITE_OPS["fused_moe_mlp"])


def test_fused_moe_mlp_grads_match_jax_vjp():
    T, d, f, E, k, C = 64, 16, 32, 8, 2, 8
    args = _moe_inputs(6, T, d, f, E)
    jargs = tuple(jnp.asarray(a) for a in args)
    g = np.random.default_rng(7).standard_normal((T, d)).astype(np.float32)
    (want, want_aux), vjp = jax.vjp(
        lambda *a: jops.fused_moe_mlp(*a, k=k, capacity=C, interpret=True), *jargs)
    want_grads = vjp((jnp.asarray(g), jnp.float32(0.5)))
    targs = tuple(_t(a).requires_grad_() for a in args)
    out, aux = ops.fused_moe_mlp(*targs, k=k, capacity=C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad((out, aux), targs, (_t(g), torch.tensor(0.5)))
    for name, got, w in zip(("x", "router", "wg", "wu", "wo"), grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# models: smoke configs against the JAX package
# ---------------------------------------------------------------------------

B, PROMPT, CACHE_LEN, N_DECODE, N_NEW = 2, 13, 20, 3, 6


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(JL.FLAGS, "use_pallas", True)
    monkeypatch.setattr(JL.FLAGS, "pallas_interpret", True)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def weights(request):
    arch = request.param
    jparams, _ = jax_get_model(jax_smoke_config(arch)).init_params(key=jax.random.PRNGKey(0))
    return arch, jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _models(arch, kv_cache_dtype="native"):
    return (jax_get_model(jax_smoke_config(arch).with_(kv_cache_dtype=kv_cache_dtype)),
            get_model(smoke_config(arch).with_(kv_cache_dtype=kv_cache_dtype)))


def _prompt():
    return np.random.default_rng(0).integers(0, 256, (B, PROMPT)).astype(np.int32)


def _close(port, ref, atol=1e-4, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_the_reference(arch):
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (smoke_config(arch), jax_smoke_config(arch))):
        for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                      "vocab", "n_experts", "experts_per_token", "capacity_factor",
                      "router_aux_weight", "fused_moe", "rope_theta", "family"):
            assert getattr(port, field) == getattr(ref, field), field
        assert port.param_count() == ref.param_count()


def test_expert_capacity_matches_the_reference():
    for T in (1, 8, 100, 513, 4096, 32768):
        for E, k, cf in ((128, 8, 1.25), (16, 4, 1.25), (8, 2, 0.5)):
            assert M.expert_capacity(T, E, k, cf) == JM.expert_capacity(T, E, k, cf)
    assert M.expert_capacity(4096, 128, 8, 1.25) == 384      # qwen3 prefill, batch 8 x 512
    assert M.expert_capacity(8, 128, 8, 1.25) == 8           # qwen3 decode, batch 8


def test_moe_params_carry_across_leaf_for_leaf(weights):
    arch, jparams, tparams = weights
    _, tm = _models(arch)
    abstract, axes = tm.init_params(abstract=True)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(jflat) == len(jax.tree_util.tree_leaves(tparams))
    for path, leaf in jflat.items():
        node, anode, axnode = tparams, abstract, axes
        for key in path:
            node, anode, axnode = node[key.key], anode[key.key], axnode[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(anode.shape)
        assert len(axnode) == leaf.ndim
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_moe_prefill_and_decode_match_jax(weights, jax_pallas):
    arch, jparams, tparams = weights
    jm, tm = _models(arch)
    toks = _prompt()
    jl, jc = jm.prefill(jparams, jnp.asarray(toks), CACHE_LEN)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks).long(), CACHE_LEN)
    assert tuple(tl.shape) == (B, 1, 256)
    _close(tl, jl)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k])
    tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for t in range(N_DECODE):
        pos = jnp.full((B,), PROMPT + t, jnp.int32)
        jl, jc = jm.decode_step(jparams, tok, jc, pos)
        before = tc["k"]
        tl, tc = tm.decode_step(tparams, _t(tok), tc, _t(pos))
        assert tc["k"] is before                                  # updated in place
        _close(tl, jl, rtol=1e-5)
        tok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for k in ("k", "v"):
        _close(tc[k], jc[k])


def test_moe_int8_cache_matches_jax(weights, jax_pallas):
    arch, jparams, tparams = weights
    jm8, tm8 = _models(arch, "int8")
    toks = _prompt()
    jl8, jc8 = jm8.prefill(jparams, jnp.asarray(toks), CACHE_LEN)
    tl8, tc8 = tm8.prefill(tparams, torch.from_numpy(toks).long(), CACHE_LEN)
    _close(tl8, jl8)
    tok = jnp.argmax(jl8[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for t in range(N_DECODE):
        pos = jnp.full((B,), PROMPT + t, jnp.int32)
        jl8, jc8 = jm8.decode_step(jparams, tok, jc8, pos)
        tl8, tc8 = tm8.decode_step(tparams, _t(tok), tc8, _t(pos))
        _close(tl8, jl8, rtol=1e-5)
        tok = jnp.argmax(jl8[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for k in ("k", "v"):
        a, b = tc8[k].numpy().astype(np.int32), np.asarray(jc8[k]).astype(np.int32)
        assert tc8[k].dtype == torch.int8 and np.abs(a - b).max() <= 1
        np.testing.assert_allclose(tc8[k + "_scale"].numpy(), np.asarray(jc8[k + "_scale"]),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("kv_cache_dtype", ["native", "int8"])
def test_moe_greedy_generate_tokens_match_jax(weights, jax_pallas, kv_cache_dtype):
    arch, jparams, tparams = weights
    jm, tm = _models(arch, kv_cache_dtype)
    prompt = np.random.default_rng(1).integers(0, 256, (B, PROMPT)).astype(np.int32)
    want = JaxServeSession(model=jm, params=jparams).generate(
        jnp.asarray(prompt), max_new_tokens=N_NEW).tokens
    got = ServeSession(model=tm, params=tparams, device="cpu").generate(
        torch.from_numpy(prompt), max_new_tokens=N_NEW)
    assert tuple(got.tokens.shape) == (B, 1 + N_NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want))


def _layer0(params):
    return {k: v[0] for k, v in params["blocks"]["moe"].items()}


def test_moe_mlp_matches_the_reference_dense_dispatch(weights):
    """The port's layer (always the fused op) against the reference's unfused
    ``dense`` dispatch, its A/B baseline, including capacity-overflow drops
    (capacity_factor 0.5).  f32; atol/rtol 2e-5 and aux rel 1e-5 because the
    two reduce the router logits and the expert products in different
    orders (the routing test measures 1.5e-6 on the gates alone)."""
    arch, jparams, tparams = weights
    jcfg = jax_smoke_config(arch).with_(capacity_factor=0.5)
    cfg = smoke_config(arch).with_(capacity_factor=0.5)
    x = np.random.default_rng(8).standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    want, want_aux = JM._moe_mlp_dense(_layer0(jparams), jnp.asarray(x), jcfg)
    got, aux = M.moe_mlp(_layer0(tparams), _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def test_moe_mlp_refuses_the_unfused_dispatch(weights):
    arch, _, tparams = weights
    cfg = smoke_config(arch).with_(fused_moe=False)
    x = _t(np.zeros((1, 4, cfg.d_model), np.float32))
    with pytest.raises(NotImplementedError, match="fused kernels only"):
        M.moe_mlp(_layer0(tparams), x, cfg)


# ---------------------------------------------------------------------------
# the two repairs, and the driver
# ---------------------------------------------------------------------------


def test_stacked_init_draws_one_layer_slice_at_a_time(monkeypatch):
    """A stacked leaf is drawn slice by slice into its own dtype: no float32
    draw is ever larger than one layer's slice of a leaf."""
    cfg = smoke_config("qwen3-moe-30b-a3b").with_(n_layers=3, d_ff=32, dtype=torch.bfloat16)
    drawn = []
    real = torch.randn

    def spy(*shape, **kw):
        drawn.append(tuple(shape[0]) if len(shape) == 1 and isinstance(shape[0], tuple)
                     else tuple(shape))
        return real(*shape, **kw)

    monkeypatch.setattr(P.torch, "randn", spy)
    params, _ = get_model(cfg).init_params(seed=0, device="cpu")
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert drawn.count((E, d, f)) == 2 * cfg.n_layers            # wi_gate, wi_up
    assert drawn.count((E, f, d)) == cfg.n_layers                # wo
    assert max(int(np.prod(s)) for s in drawn) == E * d * f      # never a whole stack
    wg = params["blocks"]["moe"]["wi_gate"]
    assert wg.dtype == torch.bfloat16 and tuple(wg.shape) == (3, E, d, f)
    assert not torch.equal(wg[0], wg[1])                          # distinct slices
    # fan-in as before: wi_gate's std is 1/sqrt(d)
    assert abs(wg.float().std().item() * d ** 0.5 - 1.0) < 0.05


def test_moe_training_forward_raises_naming_its_roadmap_item():
    cfg = smoke_config("qwen3-moe-30b-a3b")
    model = get_model(cfg)
    params, _ = model.init_params(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 10, MoE training"):
        model.forward(params, torch.zeros((1, 4), dtype=torch.long))


def test_serve_driver_runs_moe_on_cpu(capsys):
    rc = serve_driver.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "8", "--tokens", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=qwen3-moe-30b-a3b" in out and "sample token ids" in out
