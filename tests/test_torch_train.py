"""The port's training path against the JAX package on
``smoke_config("deepseek-7b")``: forward, loss and gradients, optimizer
updates, a 6-step AdamW + goyal trajectory, the storage data plane and
``Session.run``.  JAX weights are carried across by ``params_from_jax``;
inputs come from numpy or from the JAX batcher itself.  The JAX side runs
its Pallas kernels in interpret mode (``FLAGS.use_pallas=True``).

Tolerances.  ``f32``: both sides compute in float32, but XLA's CPU
``cos``/``sin``/``rsqrt`` and its reductions differ from PyTorch's in the
last bit; through two layers that is ~1e-5 relative on the loss and ~1e-4
absolute on logits and gradients.  ``int8-fused``: K/V that differ by an
ulp can round to a neighbouring int8 value at a tie, which moves an
attention output by up to one quantization step of one row; so the
int8-fused forward, gradients and losses are held to looser tolerances,
stated at each test (the quantizer itself is bit-identical on equal
inputs, ``tests/test_torch_kernels.py``).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.api import Session as JSession
from repro.api import SessionConfig as JSessionConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro.optim import sgd_momentum as jax_sgd
from repro.optim.schedules import goyal_schedule as jax_goyal
from repro.storage import DataConfig as JDataConfig
from repro.train import steps as JS
from repro_torch.api import DriftDetected, FleetSpec, Session, SessionConfig
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_driver
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, goyal_schedule, sgd_momentum
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.storage import DataConfig
from repro_torch.train import steps as S

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

SEQ, STEPS = 32, 6
PRECISIONS = ["f32", "int8-fused"]


@contextlib.contextmanager
def jax_pallas():
    old = (JL.FLAGS.use_pallas, JL.FLAGS.pallas_interpret)
    JL.FLAGS.use_pallas, JL.FLAGS.pallas_interpret = True, True
    try:
        yield
    finally:
        JL.FLAGS.use_pallas, JL.FLAGS.pallas_interpret = old


def _demo(spec_cls):
    # launch/train.py's demo fleet: tunes to groups (2, 2, 20), 60 rows
    return spec_cls.demo(2, host_tput=80.0, csd_tput=10.0, host_max_batch=64,
                         csd_max_batch=8, host_idle=100.0, csd_idle=1.5)


def _shards(spec, public=65536):
    return spec.shards(private_per_worker={"csd": 256}, public=public)


def _jax_session(prec="f32", storage=None, public=65536):
    cfg = jax_smoke_config("deepseek-7b").with_(train_precision=prec)
    spec = _demo(JFleetSpec)
    if storage is not None:
        spec = spec.with_storage(**storage)
    return JSession(model=jax_get_model(cfg), optimizer=jax_adamw(), fleet=spec,
                    data=JDataConfig(vocab=cfg.vocab, seq_len=SEQ, seed=0),
                    config=JSessionConfig(total_steps=STEPS), shards=_shards(spec, public))


def _session(prec="f32", storage=None, public=65536):
    cfg = smoke_config("deepseek-7b").with_(train_precision=prec)
    spec = _demo(FleetSpec)
    if storage is not None:
        spec = spec.with_storage(**storage)
    return Session(model=get_model(cfg), optimizer=adamw(), fleet=spec,
                   data=DataConfig(vocab=cfg.vocab, seq_len=SEQ, seed=0),
                   config=SessionConfig(total_steps=STEPS), shards=_shards(spec, public),
                   device="cpu")


@pytest.fixture(scope="module")
def jax_weights():
    params, _ = jax_get_model(jax_smoke_config("deepseek-7b")).init_params(
        key=jax.random.PRNGKey(0))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _np_batch(rows=4, seq=16, seed=7):
    toks = np.random.default_rng(seed).integers(0, 256, (rows, seq + 1)).astype(np.int32)
    mask = np.ones((rows, seq), np.float32)
    mask[-1] = 0.0                                    # one padded row, as the Stannis layout
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(b[k]))
            for k in ("tokens", "labels", "loss_mask")}


def _jax_batch(b):
    return {k: jnp.asarray(b[k]) for k in ("tokens", "labels", "loss_mask")}


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

# (atol, rtol) on logits of up to ~12: f32 ulps through two layers; int8-fused
# adds the rounding flips described above; bf16 rounds q/k/v to 8 bits of
# mantissa, where an ulp of difference in f32 can flip a bf16 rounding
FORWARD_TOL = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 0.0), "int8-fused": (2e-2, 0.0)}


@pytest.mark.parametrize("prec", ["f32", "bf16", "int8-fused"])
def test_forward_logits_match_jax(prec, jax_weights):
    jparams, np_params = jax_weights
    b = _np_batch()
    jm = jax_get_model(jax_smoke_config("deepseek-7b").with_(train_precision=prec))
    with jax_pallas():
        want, _ = jax.jit(jm.forward)(jparams, jnp.asarray(b["tokens"]))
    model = get_model(smoke_config("deepseek-7b").with_(train_precision=prec))
    with torch.no_grad():
        got, aux = model.forward(params_from_jax(np_params, "cpu"),
                                 torch.from_numpy(b["tokens"]))
    assert got.shape == (4, 16, 256) and float(aux) == 0.0
    atol, rtol = FORWARD_TOL[prec]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


# (loss rtol, gradient atol): int8-fused gradients are the base op's
# gradients at the dequantized K/V, so a flipped K/V rounding moves them by
# about one quantization step times the upstream gradient
LOSS_GRAD_TOL = {"f32": (1e-6, 1e-4), "int8-fused": (1e-4, 2e-3)}


@pytest.mark.parametrize("prec", PRECISIONS)
def test_loss_and_grads_match_jax(prec, jax_weights):
    jparams, np_params = jax_weights
    b = _np_batch()
    jm = jax_get_model(jax_smoke_config("deepseek-7b").with_(train_precision=prec))
    with jax_pallas():
        (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(
            lambda p, bt: JS.loss_fn(jm, p, bt), has_aux=True))(jparams, _jax_batch(b))
    model = get_model(smoke_config("deepseek-7b").with_(train_precision=prec))
    (total, parts), grads = S.value_and_grad(model, params_from_jax(np_params, "cpu"),
                                             _torch_batch(b))
    rtol, atol = LOSS_GRAD_TOL[prec]
    np.testing.assert_allclose(float(total), float(jtotal), rtol=rtol)
    assert float(parts["tokens"]) == float(jparts["tokens"]) == 3 * 16
    jleaves = jax.tree_util.tree_leaves(jgrads)     # dicts flatten in sorted-key order
    leaves = [grads_leaf for _, grads_leaf in sorted(_flat(grads).items())]
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-3)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_int8_fused_shrinks_residual_bytes(jax_weights):
    """Saved-for-backward bytes shrink when K/V are saved as int8 + scales."""
    _, np_params = jax_weights
    base = smoke_config("deepseek-7b").with_(remat=False)
    params, batch = params_from_jax(np_params, "cpu"), _torch_batch(_np_batch())
    f32 = S.residual_bytes(get_model(base), params, batch)
    q8 = S.residual_bytes(get_model(base.with_(train_precision="int8-fused")), params, batch)
    assert 0 < q8 < f32


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd-nesterov-wd"])
def test_optimizer_update_matches_jax(name):
    rng = np.random.default_rng(3)
    p_np = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((11,)).astype(np.float32)}}
    g_np = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((11,)).astype(np.float32)}}
    make = {"adamw": (jax_adamw, adamw, {}),
            "sgd": (jax_sgd, sgd_momentum, {}),
            "sgd-nesterov-wd": (jax_sgd, sgd_momentum, {"nesterov": True, "weight_decay": 0.1})}
    jmake, tmake, kw = make[name]
    jopt, topt = jmake(**kw), tmake(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jstate = jopt.init(jp)
    tp = params_from_jax(p_np, "cpu")
    tstate = topt.init(tp)
    for step in range(3):                               # bias correction moves with t
        jstate, jp = jopt.update(jax.tree_util.tree_map(jnp.asarray, g_np), jstate, jp,
                                 jnp.float32(1e-2))
        tstate, tp = topt.update(params_from_jax(g_np, "cpu"), tstate, tp,
                                 torch.tensor(1e-2, dtype=torch.float32))
    assert tstate.step == int(jstate.step) == 3
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(tree_leaves(tstate.mu), jax.tree_util.tree_leaves(jstate.mu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_goyal_schedule_matches_jax():
    js = jax_goyal(1e-3, 24, base_batch=256, warmup_steps=20, total_steps=100)
    ts = goyal_schedule(1e-3, 24, base_batch=256, warmup_steps=20, total_steps=100)
    for step in (0, 1, 7, 19, 20, 21, 60, 100, 150):
        assert float(ts(step)) == float(js(step)), step


# ---------------------------------------------------------------------------
# the storage data plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["synthetic", "flash"])
def test_data_plane_matches_jax_session(backend, tmp_path):
    storage = None if backend == "synthetic" else {
        "backend": "flash", "root": str(tmp_path / "port"), "codec": "u8"}
    jstorage = None if storage is None else dict(storage, root=str(tmp_path / "jax"))
    # a 4096-sample public pool keeps the flash spool small
    js, ts = _jax_session(storage=jstorage, public=4096), _session(storage=storage, public=4096)
    jt, tt = js.tune(), ts.tune()
    assert tt.batches == jt.batches
    assert tt.group_workers == jt.group_workers
    assert tt.schedule.group_batches == jt.schedule.group_batches == (2, 2, 20)
    assert dataclasses.asdict(ts.plan()) == dataclasses.asdict(js.plan())
    jm, tm = js.place(), ts.place()
    assert [dataclasses.asdict(a) for a in tm.assignments] == \
        [dataclasses.asdict(a) for a in jm.assignments]
    assert [(d.worker, d.backend, d.custody, d.n_samples) for d in tm.devices] == \
        [(d.worker, d.backend, d.custody, d.n_samples) for d in jm.devices]
    assert ts.dataset.steps_per_epoch() == js.dataset.steps_per_epoch()
    for _ in range(3):
        jb, tb = js.dataset.next_batch(), ts.dataset.next_batch()
        for k in ("tokens", "labels", "loss_mask", "row_mask"):
            np.testing.assert_array_equal(tb[k], jb[k])
            assert tb[k].dtype == jb[k].dtype
    db = ts.dataset.next_device_batch(torch.device("cpu"))
    assert db["tokens"].dtype == torch.int32 and db["tokens"].shape == (60, SEQ)


# ---------------------------------------------------------------------------
# 6-step trajectories: make_train_step and Session.run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trajectories(jax_weights):
    """The reference trajectory per precision: ``jit(make_train_step)`` with
    AdamW and the Session's goyal schedule over the JAX batcher's batches.

    It is not the JAX ``Session.run``: with the installed jax 0.9 that path
    raises ``set_mesh can only be used outside of jax.jit`` (ROADMAP §3), so
    the port is held to the reference's step and batcher instead."""
    jparams0, np_params = jax_weights
    out = {}
    for prec in PRECISIONS:
        js = _jax_session(prec)
        tp = js.tune()
        sched = jax_goyal(1e-3, tp.schedule.valid_rows, base_batch=256, warmup_steps=20,
                          total_steps=STEPS)
        opt = jax_adamw()
        with jax_pallas():
            step = jax.jit(JS.make_train_step(js.model, opt, sched))
            params, state = jparams0, opt.init(jparams0)
            batches, metrics = [], []
            for _ in range(STEPS):
                b = js.dataset.next_batch()
                batches.append(b)
                params, state, m = step(params, state, _jax_batch(b))
                metrics.append({k: float(v) for k, v in m.items()})
        out[prec] = (batches, metrics, jax.tree_util.tree_map(np.asarray, params))
    return out


# per-step loss rtol: f32 ulps; int8-fused rounding flips (measured ~3e-4)
TRAJ_RTOL = {"f32": 1e-5, "int8-fused": 2e-3}
# grad_norm rtol.  Step 1 sees the same weights on both sides (measured
# 1.8e-5 for both precisions).  After it the int8-fused weights drift apart
# through K/V rounding flips, and the grad norm amplifies that drift
# (measured up to 8.3e-5 for f32 and 4.6e-2 for int8-fused over 6 steps).
GRAD_NORM_RTOL_FIRST = 1e-4
GRAD_NORM_RTOL = {"f32": 3e-4, "int8-fused": 1e-1}


@pytest.mark.parametrize("prec", PRECISIONS)
def test_train_step_trajectory_matches_jax(prec, jax_weights, jax_trajectories):
    _, np_params = jax_weights
    batches, want, want_params = jax_trajectories[prec]
    model = get_model(smoke_config("deepseek-7b").with_(train_precision=prec))
    sched = goyal_schedule(1e-3, 24, base_batch=256, warmup_steps=20, total_steps=STEPS)
    opt = adamw()
    step = S.make_train_step(model, opt, sched)
    params = params_from_jax(np_params, "cpu")
    state = opt.init(params)
    for i, (b, w) in enumerate(zip(batches, want)):
        params, state, m = step(params, state, _torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), w["loss"], rtol=TRAJ_RTOL[prec])
        np.testing.assert_allclose(
            float(m["grad_norm"]), w["grad_norm"],
            rtol=GRAD_NORM_RTOL_FIRST if i == 0 else GRAD_NORM_RTOL[prec])
        assert float(m["lr"]) == w["lr"] and float(m["tokens"]) == w["tokens"] == 24 * SEQ
    if prec == "f32":
        for got, want_leaf in zip(sorted(_flat(params).items()),
                                  jax.tree_util.tree_leaves(want_params)):
            np.testing.assert_allclose(got[1].numpy(), want_leaf, atol=1e-4)
    assert state.step == STEPS


@pytest.mark.parametrize("prec", PRECISIONS)
def test_session_run_matches_jax_loop(prec, jax_weights, jax_trajectories):
    """``Session.run`` (tune -> plan -> place -> dataset -> shard -> compile
    -> run) trains on the same batches with the same schedule as the JAX
    loop in ``jax_trajectories``, whose docstring says why that loop and not
    the JAX ``Session.run`` is the reference."""
    _, np_params = jax_weights
    _, want, _ = jax_trajectories[prec]
    session = _session(prec)
    report = session.run(params_from_jax(np_params, "cpu"))
    assert report.steps_run == STEPS and session.compile_count == 1
    np.testing.assert_allclose([h["loss"] for h in report.history],
                               [w["loss"] for w in want], rtol=TRAJ_RTOL[prec])
    assert [h["lr"] for h in report.history] == [w["lr"] for w in want]


# ---------------------------------------------------------------------------
# Session behaviour of its own
# ---------------------------------------------------------------------------


def test_drift_retune_keeps_compiled_step():
    s = _session()
    step = s.compile()
    result = s.apply(DriftDetected())
    assert not result.recompiled and s.compile() is step and s.compile_count == 1
    assert s.tune().schedule.global_rows == 60


def test_unported_paths_raise_naming_their_roadmap_item(capsys):
    # cluster execution is ported (tests/test_torch_cluster.py, the spmd mode
    # tests/test_torch_spmd.py), and so is the measured tune
    # (tests/test_torch_tune.py); what stays unported is several devices a
    # process (the rest of the second half of item 19)
    from repro_torch.launch.mesh import ClusterContext

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClusterContext(process_id=0, n_processes=2, mode="spmd").local_mesh(8, data_axis=4)
    s = _session(storage={"backend": "meshfeed", "data_axis": 4})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.devices
    with pytest.raises(SystemExit):
        train_driver.main(["--device", "cpu", "--cluster-processes", "2",
                           "--cluster-local-devices", "2"])
    assert "ROADMAP" in capsys.readouterr().err


def test_train_driver_runs_on_cpu(capsys):
    assert train_driver.main(["--device", "cpu", "--steps", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "schedule: groups=(2, 2, 20)" in out and "2 steps in" in out
