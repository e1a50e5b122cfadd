"""Elastic replanning, restart and membership in the port's ``Session``,
against the JAX ``Session``.

``Session.apply`` runs the same sequence of ``WorkerLost`` / ``WorkerJoined``
/ ``DriftDetected`` events on both packages (the cases of
``tests/test_session.py``'s elastic tests) and the results are held field
for field: membership, the schedule, the Eq.-1 plan, per-device custody,
the dropped shards and the custody log.  The JAX side runs tune / plan /
place only: its ``Session.run`` fails under the installed jax 0.9 (ROADMAP
§3), as do its ``test_train_steps::{test_restart_resumes_from_checkpoint,
test_worker_lost_replans}``, so restart and training after an event are
held on the port alone (bit-equal to an uninterrupted run) and the
quickstart to the reference's ``jit(make_train_step)``.

CPU runs are bit-reproducible only with deterministic algorithms: the
embedding gather's backward otherwise accumulates rows in a thread-dependent
order, so the restart tests switch them on.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DriftDetected as JDrift
from repro.api import FleetSpec as JFleetSpec
from repro.api import Session as JSession
from repro.api import SessionConfig as JSessionConfig
from repro.api import WorkerJoined as JJoined
from repro.api import WorkerLost as JLost
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro.optim.schedules import goyal_schedule as jax_goyal
from repro.storage import DataConfig as JDataConfig
from repro.train import steps as JS
from repro_torch.api import (
    CallbackRegistry, DirMembershipSource, DriftDetected, ElasticController, FleetSpec,
    MembershipWatcher, Session, SessionConfig, WorkerJoined, WorkerLost,
)
from repro_torch.api.membership import write_heartbeat
from repro_torch.configs import smoke_config
from repro_torch.core.privacy import audit_custody
from repro_torch.examples import quickstart
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_driver
from repro_torch.launch.train import train_session_factory
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.storage import DataConfig

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

SEQ = 16


def _jax_session(n_csds, storage=None):
    cfg = jax_smoke_config("deepseek-7b")
    spec = JFleetSpec.demo(n_csds)
    if storage is not None:
        spec = spec.with_storage(**storage)
    return JSession(model=jax_get_model(cfg), optimizer=jax_adamw(), fleet=spec,
                    data=JDataConfig(vocab=cfg.vocab, seq_len=SEQ),
                    shards=spec.shards(private_per_worker={"csd": 64}, public=4096),
                    config=JSessionConfig(total_steps=4))


def _session(n_csds, storage=None, callbacks=None, steps=4):
    cfg = smoke_config("deepseek-7b")
    spec = FleetSpec.demo(n_csds)
    if storage is not None:
        spec = spec.with_storage(**storage)
    return Session(model=get_model(cfg), optimizer=adamw(), fleet=spec,
                   data=DataConfig(vocab=cfg.vocab, seq_len=SEQ),
                   shards=spec.shards(private_per_worker={"csd": 64}, public=4096),
                   config=SessionConfig(total_steps=steps), callbacks=callbacks,
                   device="cpu")


def _state(s):
    """Everything ``apply`` decides, in plain values."""
    tp = s.tune()
    m = s.place()
    return {
        "group_workers": tp.group_workers,
        "schedule": (tp.schedule.group_batches, tp.schedule.max_local,
                     tp.schedule.global_rows, tp.schedule.valid_rows),
        "fleet": tuple((c.name, c.count) for c in s.fleet.classes),
        "steps_per_epoch": s.plan().steps_per_epoch,
        "imbalance": s.plan().imbalance_steps(),
        "assignments": tuple(dataclasses.astuple(a) for a in m.assignments),
        "devices": tuple((d.worker, d.backend, d.custody, d.n_samples) for d in m.devices),
        "quarantined": m.quarantined,
        "shards": tuple((sh.shard_id, sh.owner, sh.private, sh.n_samples) for sh in s.shards),
        "custody_log": tuple(dataclasses.astuple(e) for e in s.devices.custody_log),
        "dataset_sources": s.dataset.group_sources,
    }


def _port_event(e):
    return {JLost: lambda: WorkerLost(e.workers), JJoined: lambda: WorkerJoined(e.class_name, e.count),
            JDrift: lambda: DriftDetected()}[type(e)]()


# (n_csds, events): the elastic cases of tests/test_session.py; "force" is
# tune(force=True), "override" installs a donor session's TunePlan
SCENARIOS = {
    "lost": (3, [JLost(["csd/1"])]),
    "joined": (2, [JJoined("csd", 2)]),
    "lost_then_drift": (3, [JLost(["csd/1"]), JDrift()]),
    "lost_then_joined_fresh_label": (3, [JLost(["csd/1"]), JJoined("csd", 1)]),
    "highest_index_lost_then_joined": (3, [JLost(["csd/2"]), JJoined("csd", 1)]),
    "lost_then_force_retune": (3, [JLost(["csd/1"]), "force"]),
    "override_then_joined": (2, ["override", JJoined("csd", 1)]),
    "class_death_then_rejoin": (1, [JLost(["csd/0"]), JJoined("csd", 1)]),
    "drift_after_batches": (2, ["batch", JDrift()]),
    "lost_two_then_joined_two": (3, [JLost(["csd/0", "host/0"]), JJoined("host", 1),
                                     JJoined("csd", 2), JDrift()]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_apply_matches_jax_session(name):
    n_csds, events = SCENARIOS[name]
    js, ts = _jax_session(n_csds), _session(n_csds)
    assert _state(ts) == _state(js)
    for e in events:
        if e == "force":
            js.tune(force=True), ts.tune(force=True)
        elif e == "override":
            js.override("tune", _jax_session(n_csds).tune())
            ts.override("tune", _session(n_csds).tune())
        elif e == "batch":
            for s in (js, ts):
                s.dataset.next_batch()
                s.dataset.next_batch()
        else:
            before = ts.tune().schedule
            jr, tr = js.apply(e), ts.apply(_port_event(e))
            assert tr.dropped_shards == jr.dropped_shards
            assert tr.tune_plan.group_workers == jr.tune_plan.group_workers
            assert tr.recompiled is False            # nothing compiled yet
            # the pinned capacity never shrinks across an event
            assert ts.tune().schedule.max_local >= before.max_local
        assert _state(ts) == _state(js), e
        assert ts.dataset.cursors() == js.dataset.cursors()
        assert audit_custody(ts.devices.custody_log) == audit_custody(js.devices.custody_log) == {
            "private_shards_rehomed": 0, "private_shards_resurrected": 0,
            "duplicate_provisions": 0}
        workers = ts.tune().group_workers
        assert len(set(workers)) == len(workers)     # a label is never reused


def test_worker_lost_quarantines_and_keeps_capacity():
    s = _session(3)
    tp = s.tune()
    s.place()
    res = s.apply(WorkerLost(["csd/1"]))
    tp2 = s.tune()
    assert tp2.schedule.n_groups == tp.schedule.n_groups - 1
    assert tp2.schedule.max_local == tp.schedule.max_local
    assert res.dropped_shards == ("private-csd/1",)
    assert s.plan().imbalance_steps() == 0
    m = s.place()
    assert "private-csd/1" in m.quarantined and m.device_for("csd/1") is None
    assert all(a.worker != "csd/1" and a.shard_id != "private-csd/1" for a in m.assignments)
    assert all(sh.owner != "csd/1" for sh in s.shards if sh.private)
    assert [e.kind for e in s.devices.custody_log if e.src == "csd/1"] == ["quarantine"]
    # the public pool's custodian dies: its custody moves to a survivor
    public = next(sh.shard_id for sh in s.shards if not sh.private)
    holder = s.devices.custodian(public)
    s.apply(WorkerLost([holder]))
    assert [e.kind for e in s.devices.custody_log if e.src == holder] == ["quarantine", "rehome"]
    assert s.devices.custodian(public) in s.tune().group_workers


@pytest.mark.parametrize("event", [WorkerLost(["csd/99"]), WorkerJoined("gpu", 1)],
                         ids=["lost_unknown", "joined_unknown_class"])
def test_unknown_members_raise(event):
    s = _session(2)
    with pytest.raises(KeyError):
        s.apply(event)
    with pytest.raises(ValueError):
        s.apply(WorkerLost(["csd/0", "csd/1", "host/0"]))


def test_flash_backend_shreds_the_dead_workers_private_shard(tmp_path):
    s = _session(2, storage={"backend": "flash", "root": str(tmp_path), "codec": "u8"})
    for _ in range(2):
        s.dataset.next_batch()
    dev = s.devices.device("csd/1")
    shard = next(sh for sh in s.shards if sh.shard_id == "private-csd/1")
    path = dev._shard_path(shard)
    assert os.path.exists(path)
    s.apply(WorkerLost(["csd/1"]))
    assert not os.path.exists(path)
    assert os.path.exists(s.devices.device("csd/0")._shard_path(
        next(sh for sh in s.shards if sh.shard_id == "private-csd/0")))


def test_events_fire_their_callbacks_and_training_recompiles_once():
    cb = CallbackRegistry()
    seen = {"retune": [], "fleet": []}
    cb.on_retune(lambda e, tp: seen["retune"].append(e))
    cb.on_fleet_change(lambda e, r: seen["fleet"].append((e, r)))
    s = _session(3, callbacks=cb, steps=2)
    r = s.run()
    compiled = s.compile()
    assert not s.apply(DriftDetected()).recompiled and s.compile() is compiled
    res = s.apply(WorkerLost(["csd/0"]))
    assert res.recompiled and len(seen["retune"]) == 1
    assert seen["fleet"] == [(WorkerLost(["csd/0"]), res)]
    r = s.run(r.params, opt_state=r.opt_state, steps=2)
    assert s.compile_count == 2 and np.isfinite(r.final_loss)
    assert r.opt_state.step == 4                 # the lr schedule continues


# ---------------------------------------------------------------------------
# restart from a checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture
def deterministic():
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old)


def _recording(session):
    """Keep a copy of every host batch the session's batcher hands out."""
    seen = []
    ds = session.dataset
    inner = ds.next_batch

    def next_batch():
        b = inner()
        seen.append(b["tokens"].copy())
        return b

    ds.next_batch = next_batch
    return seen


@pytest.mark.parametrize("async_", [True, False], ids=["async", "sync"])
def test_restart_resumes_bit_equal(tmp_path, deterministic, async_):
    kw = dict(steps=6, seq=SEQ, device="cpu")
    s0 = train_session_factory(**kw)
    b0 = _recording(s0)
    r0 = s0.run()
    ck = dict(kw, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    s1 = train_session_factory(**ck)
    s1.config.async_checkpoint = async_
    saved = []
    s1.callbacks.on_checkpoint(lambda step, d: saved.append((step, d)))
    r1 = s1.run(steps=3)
    assert saved == [(3, str(tmp_path))] and r1.start_step == 0
    s2 = train_session_factory(**ck)
    b2 = _recording(s2)
    r2 = s2.run()
    assert r2.start_step == 3 and r2.steps_run == 3
    np.testing.assert_array_equal(b2[0], b0[3])          # the same next batch
    for key in ("loss", "grad_norm", "lr"):
        assert [h[key] for h in r2.history] == [h[key] for h in r0.history[3:]], key
    assert r2.opt_state.step == 6
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000006"]


def test_launch_train_resumes_from_its_checkpoint_dir(tmp_path, capsys):
    # launch.train saves every SessionConfig.checkpoint_every (50) steps
    argv = ["--device", "cpu", "--seq", "8", "--checkpoint-dir", str(tmp_path)]
    assert train_driver.main(argv + ["--steps", "50"]) == 0
    assert "50 steps in" in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["step_0000000050"]
    assert train_driver.main(argv + ["--steps", "52"]) == 0
    out = capsys.readouterr().out
    assert "resumed from the checkpoint at step 50" in out and "2 steps in" in out


# ---------------------------------------------------------------------------
# membership -> events -> apply
# ---------------------------------------------------------------------------


def test_elastic_controller_applies_a_stale_member_as_worker_lost(tmp_path):
    d = str(tmp_path)
    write_heartbeat(d, "proc-0", ("host/0", "csd/0"), pid=1)
    write_heartbeat(d, "proc-1", ("csd/1",), pid=2)
    s = _session(2)
    ctl = ElasticController(s, MembershipWatcher(DirMembershipSource(d, stale_after=5.0)))
    assert ctl.step() == []                              # the first poll is the baseline
    old = time.time() - 60
    os.utime(os.path.join(d, "proc-1.member.json"), (old, old))
    results = ctl.step()
    assert ctl.applied == [WorkerLost(("csd/1",))]
    assert [r.dropped_shards for r in results] == [("private-csd/1",)]
    assert s.tune().group_workers == ("csd/0", "host/0")
    write_heartbeat(d, "proc-2", ("csd/7",), pid=3)        # a new member joins
    ctl.step()
    assert ctl.applied[-1] == WorkerJoined("csd", 1)
    assert s.tune().group_workers == ("csd/0", "host/0", "csd/2")


# ---------------------------------------------------------------------------
# the quickstart example against the reference's step
# ---------------------------------------------------------------------------


def test_quickstart_matches_jax_train_step():
    """``repro_torch.examples.quickstart`` from the reference's weights, held
    to ``jit(make_train_step)`` over the JAX batcher of the reference
    quickstart's session (its plain attention path), f32 tolerances as in
    ``tests/test_torch_train.py``."""
    steps = 6
    cfg = jax_smoke_config("deepseek-7b")
    jm = jax_get_model(cfg)
    jparams, _ = jm.init_params(key=jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    spec = JFleetSpec.demo(n_csds=2)
    js = JSession(model=jm, optimizer=jax_adamw(), fleet=spec,
                  data=JDataConfig(vocab=cfg.vocab, seq_len=quickstart.SEQ),
                  shards=spec.shards(private_per_worker={"csd": 64}, public=4096),
                  config=JSessionConfig(total_steps=steps))
    sched = jax_goyal(1e-3, js.tune().schedule.valid_rows, base_batch=256, warmup_steps=20,
                      total_steps=steps)
    opt = jax_adamw()
    step = jax.jit(JS.make_train_step(jm, opt, sched))
    params, state, want = jparams, opt.init(jparams), []
    for _ in range(steps):
        b = js.dataset.next_batch()
        params, state, m = step(params, state, {k: jnp.asarray(b[k]) for k in
                                                ("tokens", "labels", "loss_mask")})
        want.append({k: float(v) for k, v in m.items()})
    report = quickstart.main(["--device", "cpu", "--steps", str(steps)],
                             params=params_from_jax(np_params, "cpu"))
    assert report.steps_run == steps
    np.testing.assert_allclose([h["loss"] for h in report.history],
                               [w["loss"] for w in want], rtol=1e-5)
    # the lr equals the reference schedule's eager value; inside jit XLA folds
    # the division by warmup_steps into a multiply by its reciprocal, which
    # can move it by one float32 ulp
    assert [h["lr"] for h in report.history] == [float(sched(i)) for i in range(steps)]
    np.testing.assert_allclose([h["lr"] for h in report.history], [w["lr"] for w in want],
                               rtol=2 ** -23)
