"""The port's recurrent training path against the JAX package: the
differentiable WKV-6 and RG-LRU scan ops and their int8-fused variants
(forward, final state and the gradient of every input), and the
rwkv6-7b / recurrentgemma-2b smoke models' training forward, loss gradients
and 6-step AdamW trajectories in ``f32``, ``bf16`` and ``int8-fused``.  The
JAX side runs its Pallas kernels in interpret mode (``FLAGS.use_pallas``),
as tests/test_kernels.py runs them; inputs come from numpy, weights cross
over through ``params_from_jax``, batches come from the JAX batcher.

Tolerances and why:
* scan ops, forward: as tests/test_torch_recurrent.py (WKV: rtol 1e-5 plus
  1e-5 of the largest |value|, the chunked log-space kernel against the
  token-serial plain version; RG-LRU: rtol 1e-5, atol 1e-6).  The int8
  variants quantize equal float inputs to equal bytes and scales (the
  training quantizer is bit-identical, tests/test_torch_kernels.py), so
  they are held to the same tolerances;
* scan ops, gradients: both sides take the vjp of the plain scan (the
  port's in 32-step chunks); float32 sums reassociate, held to 2e-5 of each
  gradient's largest |value|;
* models: FORWARD_TOL and GRAD_TOL below, per precision, with the reason at
  each.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.api import Session as JSession
from repro.api import SessionConfig as JSessionConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as JO
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro.optim.schedules import goyal_schedule as jax_goyal
from repro.storage import DataConfig as JDataConfig
from repro.train import steps as JS
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.launch import train as train_driver
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, goyal_schedule
from repro_torch.train import steps as S

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

RECURRENT = ["rwkv6-7b", "recurrentgemma-2b"]
PRECISIONS = ["f32", "bf16", "int8-fused"]
CASES = [(a, p) for a in RECURRENT for p in PRECISIONS]
SEQ = 40            # 32 + 8: a ragged WKV chunk, and longer than recurrentgemma's window 8
TRAJ_SEQ, STEPS = 16, 6


@contextlib.contextmanager
def jax_pallas():
    old = (JL.FLAGS.use_pallas, JL.FLAGS.pallas_interpret)
    JL.FLAGS.use_pallas, JL.FLAGS.pallas_interpret = True, True
    try:
        yield
    finally:
        JL.FLAGS.use_pallas, JL.FLAGS.pallas_interpret = old


def _t(a):
    return torch.from_numpy(np.array(a))


def _scaled_close(port, ref, rtol):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(port, dtype=np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the scan ops: forward, final state and gradients against the JAX ops
# ---------------------------------------------------------------------------


def _wkv_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B, S_, H, D = shape
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal(shape) * 0.5)).astype(np.float32)   # in (0, 1)
    u = rng.standard_normal((H, D)).astype(np.float32)
    g_out = rng.standard_normal(shape).astype(np.float32)
    g_state = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return (r, k, v, w, u), (g_out, g_state)


WKV_OPS = {   # name -> (JAX op, port op, port plain version)
    "rwkv6_scan": (lambda *a: JO.rwkv6_scan(*a, interpret=True),
                   lambda *a: ops.rwkv6_scan(*a), lambda *a: R.rwkv6_scan_ref(*a)),
    "rwkv6_scan_q8": (lambda *a: JO.rwkv6_scan_q8(*a, interpret=True),
                      lambda *a: ops.rwkv6_scan_q8(*a), lambda *a: R.rwkv6_scan_q8_ref(*a)),
}


@pytest.mark.parametrize("shape", [(2, 45, 4, 16), (1, 64, 2, 64)], ids=str)
@pytest.mark.parametrize("name", list(WKV_OPS))
def test_wkv_op_and_its_gradients_match_jax(name, shape):
    """(2, 45, 4, 16): the smoke head dim, S = 32 + 13 (a ragged last chunk
    of the kernel and of the chunked recompute); (1, 64, 2, 64): rwkv6-7b's
    head dim over two whole chunks.  The loss weighs the output AND the
    final state, so the backward carries dS across the chunk boundaries."""
    args, (g_out, g_state) = _wkv_inputs(shape, 0)
    jop, op, plain = WKV_OPS[name]

    def jloss(*a):
        out, s = jop(*a)
        return jnp.sum(out * g_out) + jnp.sum(s * g_state), (out, s)

    (_, (jout, jstate)), jgrads = jax.value_and_grad(jloss, argnums=range(5), has_aux=True)(
        *(jnp.asarray(a) for a in args))
    targs = [_t(a).requires_grad_() for a in args]
    out, state = op(*targs)
    assert out.dtype == torch.float32 and tuple(state.shape) == (shape[0], shape[2], shape[3],
                                                                 shape[3])
    _scaled_close(out.detach(), jout, 1e-5)
    _scaled_close(state.detach(), jstate, 1e-5)
    grads = torch.autograd.grad((out * _t(g_out)).sum() + (state * _t(g_state)).sum(), targs)
    for got, want, arg in zip(grads, jgrads, "rkvwu"):
        assert got.dtype == torch.float32, arg
        _scaled_close(got, want, 2e-5)
    # on a CPU tensor the op's forward IS its plain version
    ref_out, ref_state = plain(*(t.detach() for t in targs))
    assert torch.equal(out.detach(), ref_out) and torch.equal(state.detach(), ref_state)


def test_wkv_q8_gradients_come_back_in_the_inputs_dtypes():
    """bf16 r/k/v and decay, as at full width: the int8-fused op returns its
    output in r's dtype and each gradient in its input's dtype (the
    reference's ``_dtype_tag``); u stays float32."""
    (r, k, v, w, u), (g_out, _) = _wkv_inputs((1, 20, 2, 16), 3)
    targs = [_t(a).to(torch.bfloat16).requires_grad_() for a in (r, k, v, w)]
    tu = _t(u).requires_grad_()
    out, _ = ops.rwkv6_scan_q8(*targs, tu)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad((out.float() * _t(g_out)).sum(), [*targs, tu])
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4 + [torch.float32]


RGLRU_OPS = {   # name -> (JAX op, port op, port plain version)
    "rglru_scan": (lambda a, x: JO.rglru_scan(a, x, interpret=True),
                   lambda a, x: ops.rglru_scan(a, x), lambda a, x: R.rglru_scan_ref(a, x)),
    "rglru_scan_q8": (lambda a, x: JO.rglru_scan_q8(a, x, interpret=True),
                      lambda a, x: ops.rglru_scan_q8(a, x),
                      lambda a, x: R.rglru_scan_q8_ref(a, x)),
}


# every third step's decays exactly 1.0 (the TPU kernel's padding value)
RGLRU_A_ONE = (2, 33, 64)


@pytest.mark.parametrize("shape", [(2, 45, 300), (1, 130, 256), (2, 1, 300), RGLRU_A_ONE],
                         ids=str)
@pytest.mark.parametrize("name", list(RGLRU_OPS))
def test_rglru_op_and_its_gradients_match_jax(name, shape):
    """(2, 45, 300): ragged in S and W against the kernel's 128 x 256 tiles;
    (1, 130, 256): past one sequence chunk; (2, 1, 300): one step;
    RGLRU_A_ONE: rows of decays exactly 1.0; rows of W quantized for q8."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    if shape == RGLRU_A_ONE:
        a[:, ::3] = 1.0
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jop, op, plain = RGLRU_OPS[name]
    jy, vjp = jax.vjp(jop, jnp.asarray(a), jnp.asarray(x))
    jda, jdx = vjp(jnp.asarray(g))
    ta, tx = _t(a).requires_grad_(), _t(x).requires_grad_()
    y = op(ta, tx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    da, dx = torch.autograd.grad(y, (ta, tx), _t(g))
    _scaled_close(da, jda, 2e-5)
    _scaled_close(dx, jdx, 2e-5)
    assert torch.equal(y.detach(), plain(ta.detach(), tx.detach()))


# ---------------------------------------------------------------------------
# the models: training forward and loss gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Numpy weights of the smoke config, every all-zero leaf (the RG-LRU
    gate weights, the decay LoRA's B, norm biases) replaced by small random
    values so that the gates, decays and their gradients vary."""
    jparams, _ = jax_get_model(jax_smoke_config(arch)).init_params(key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def fill(a):
        a = np.asarray(a)
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype) if not a.any() else a

    return jax.tree_util.tree_map(fill, jparams)


def _jparams(arch):
    return jax.tree_util.tree_map(jnp.asarray, _weights(arch))


def _np_batch(rows=3, seq=SEQ, seed=7):
    toks = np.random.default_rng(seed).integers(0, 256, (rows, seq + 1)).astype(np.int32)
    mask = np.ones((rows, seq), np.float32)
    mask[-1] = 0.0                                    # one padded row, as the Stannis layout
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(b[k]))
            for k in ("tokens", "labels", "loss_mask")}


def _jax_batch(b):
    return {k: jnp.asarray(b[k]) for k in ("tokens", "labels", "loss_mask")}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# atol on logits as a share of the largest |logit| (~32 here): f32 is float32
# reassociation and XLA's CPU transcendentals through two or three layers
# (measured 6.7e-6); bf16 rounds r/k/v or q/k/v to 8 bits of mantissa, where
# an ulp of difference in float32 can flip a bf16 rounding, and int8-fused
# likewise at an int8 rounding tie (one quantization step of one row), which
# the WKV state carries along the sequence (measured 2.3e-3 on rwkv6, a
# twentieth of what int8 itself moves the logits from f32)
FORWARD_TOL = {"f32": 1e-5, "bf16": 5e-3, "int8-fused": 5e-3}


@pytest.mark.parametrize("arch,prec", CASES)
def test_forward_logits_match_jax(arch, prec):
    b = _np_batch()
    jm = jax_get_model(jax_smoke_config(arch).with_(train_precision=prec))
    with jax_pallas():
        want, _ = jax.jit(jm.forward)(_jparams(arch), jnp.asarray(b["tokens"]))
    model = get_model(smoke_config(arch).with_(train_precision=prec))
    with torch.no_grad():
        got, aux = model.forward(params_from_jax(_weights(arch), "cpu"),
                                 torch.from_numpy(b["tokens"]))
    assert got.shape == (3, SEQ, 256) and float(aux) == 0.0
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FORWARD_TOL[prec] * np.abs(want).max())


# (loss rtol, gradient atol as a share of each leaf's largest |gradient|):
# f32 reassociation; bf16 and int8-fused roundings that flip at a tie move a
# gradient by about one rounding step times the upstream gradient
GRAD_TOL = {"f32": (1e-5, 1e-4), "bf16": (2e-3, 2e-2), "int8-fused": (2e-3, 2e-2)}


@pytest.mark.parametrize("arch,prec", CASES)
def test_loss_and_grads_match_jax(arch, prec):
    b = _np_batch()
    jm = jax_get_model(jax_smoke_config(arch).with_(train_precision=prec))
    with jax_pallas():
        (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(
            lambda p, bt: JS.loss_fn(jm, p, bt), has_aux=True))(_jparams(arch), _jax_batch(b))
    model = get_model(smoke_config(arch).with_(train_precision=prec))
    (total, parts), grads = S.value_and_grad(model, params_from_jax(_weights(arch), "cpu"),
                                             _torch_batch(b))
    rtol, share = GRAD_TOL[prec]
    np.testing.assert_allclose(float(total), float(jtotal), rtol=rtol)
    assert float(parts["tokens"]) == float(jparts["tokens"]) == 2 * SEQ
    jleaves = jax.tree_util.tree_leaves(jgrads)     # dicts flatten in sorted-key order
    leaves = sorted(_flat(grads).items())
    assert len(leaves) == len(jleaves)
    for (name, got), want in zip(leaves, jleaves):
        want = np.asarray(want, dtype=np.float32)
        assert float(np.abs(want).max()) > 0, name
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=share * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("arch", RECURRENT)
def test_int8_fused_shrinks_residual_bytes(arch):
    """Saved-for-backward bytes shrink when the scans (and recurrentgemma's
    attention) save their streamed activations as int8 + row scales."""
    base = smoke_config(arch).with_(remat=False)
    params, batch = params_from_jax(_weights(arch), "cpu"), _torch_batch(_np_batch())
    f32 = S.residual_bytes(get_model(base), params, batch)
    q8 = S.residual_bytes(get_model(base.with_(train_precision="int8-fused")), params, batch)
    assert 0 < q8 < f32


# ---------------------------------------------------------------------------
# 6-step trajectories against jit(make_train_step) over the JAX batcher
# ---------------------------------------------------------------------------


def _demo(spec_cls):
    # launch/train.py's demo fleet: tunes to groups (2, 2, 20), 60 rows
    return spec_cls.demo(2, host_tput=80.0, csd_tput=10.0, host_max_batch=64,
                         csd_max_batch=8, host_idle=100.0, csd_idle=1.5)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(arch, prec):
    """``jit(make_train_step)`` with AdamW and the Session's goyal schedule
    over the JAX batcher's batches: the JAX ``Session.run`` raises under the
    installed jax 0.9 (ROADMAP §3), so the port is held to the reference's
    step and batcher, as tests/test_torch_train.py holds the dense model."""
    cfg = jax_smoke_config(arch).with_(train_precision=prec)
    spec = _demo(JFleetSpec)
    js = JSession(model=jax_get_model(cfg), optimizer=jax_adamw(), fleet=spec,
                  data=JDataConfig(vocab=cfg.vocab, seq_len=TRAJ_SEQ, seed=0),
                  config=JSessionConfig(total_steps=STEPS),
                  shards=spec.shards(private_per_worker={"csd": 256}, public=4096))
    sched = jax_goyal(1e-3, js.tune().schedule.valid_rows, base_batch=256, warmup_steps=20,
                      total_steps=STEPS)
    opt = jax_adamw()
    with jax_pallas():
        step = jax.jit(JS.make_train_step(js.model, opt, sched))
        params = _jparams(arch)
        state = opt.init(params)
        batches, metrics = [], []
        for _ in range(STEPS):
            b = js.dataset.next_batch()
            batches.append(b)
            params, state, m = step(params, state, _jax_batch(b))
            metrics.append({k: float(v) for k, v in m.items()})
    return batches, metrics


# Step 1, where both sides hold the same weights: (loss rtol, grad_norm
# rtol), float32 reassociation (measured 3.3e-7 and 3.8e-6) and bf16 / int8
# rounding flips (measured up to 4.0e-6 and 3.3e-4).  Steps 2-6: loss rtol
# 3e-3 for every precision.  The first AdamW step is a sign step (m / sqrt(v)
# = ±1 per element), so a gradient element whose sign differs by a rounding
# moves its weight by 2 lr, and these untrained smoke models (logits of
# ~32) amplify such drift: the port's own trajectory moves by as much when
# its weights move by 1e-7 of their largest |value| (measured: recurrentgemma
# f32 loss 1.0e-3 at step 6, against 5.9e-4 from the JAX loop; rwkv6 bf16
# grad norm 66.3 or 6.3 at step 6).  So grad_norm is held at step 1 only.
TRAJ_FIRST_RTOL = {"f32": (1e-5, 1e-4), "bf16": (1e-4, 2e-3), "int8-fused": (1e-4, 2e-3)}
TRAJ_LOSS_RTOL = 3e-3


@pytest.mark.parametrize("arch,prec", CASES)
def test_train_step_trajectory_matches_jax(arch, prec):
    batches, want = _jax_trajectory(arch, prec)
    model = get_model(smoke_config(arch).with_(train_precision=prec))
    sched = goyal_schedule(1e-3, 24, base_batch=256, warmup_steps=20, total_steps=STEPS)
    opt = adamw()
    step = S.make_train_step(model, opt, sched)
    params = params_from_jax(_weights(arch), "cpu")
    state = opt.init(params)
    first_loss_rtol, gnorm_rtol = TRAJ_FIRST_RTOL[prec]
    for i, (b, w) in enumerate(zip(batches, want)):
        params, state, m = step(params, state, _torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), w["loss"],
                                   rtol=first_loss_rtol if i == 0 else TRAJ_LOSS_RTOL)
        assert np.isfinite(float(m["grad_norm"]))
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), w["grad_norm"], rtol=gnorm_rtol)
        assert float(m["lr"]) == w["lr"] and float(m["tokens"]) == w["tokens"] == 24 * TRAJ_SEQ
    assert state.step == STEPS


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_driver_runs_recurrent_on_cpu(capsys, arch):
    assert train_driver.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                              "--seq", "16", "--precision", "int8-fused"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "precision=int8-fused" in out and "2 steps in" in out
