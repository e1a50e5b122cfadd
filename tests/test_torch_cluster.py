"""Multi-process cluster execution of the port (``hostsync``): process
custody, per-process feeding, the coordinated checkpoint, and real
multi-process runs on the CPU.

The custody records and the coordinated checkpoint's files are held to the
JAX package's on the same fleet and the same values.  Three cluster
launches run 2 worker processes each (fresh interpreters, the plain
PyTorch path on the CPU):

* the default transport (star, no compression): bit-identical replicas,
  losses equal to the single-process port ``Session`` at rtol 1e-5 (f32 sums
  of two slabs against one sum), each process fed half the rows;
* ``TransportSpec.production()`` (int8, ring, 2 buckets, overlap):
  bit-identical replicas, step 1 equal (its loss is read from raw sums);
* the elastic kill path, a port of the reference's
  ``tests/test_cluster.py::test_elastic_kill_replan_restore_rejoin``.  That
  reference test fails in this repo's test runs, so the port is held to its
  assertions, not to its result.
"""
import os
import time

import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.api import Session as JSession
from repro.api import SessionConfig as JSessionConfig
from repro.checkpoint import manager as JM
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.mesh import ClusterContext as JClusterContext
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro.storage import DataConfig as JDataConfig
from repro_torch.api import (
    DirMembershipSource, FleetSpec, MembershipWatcher, WorkerJoined, WorkerLost,
)
from repro_torch.checkpoint import ClusterCheckpointManager, latest_step, restore
from repro_torch.core.topology import ClusterSpec, TransportSpec
from repro_torch.launch import train as train_driver
from repro_torch.launch.cluster import ClusterCoordinator, _params_digest, demo_session_factory
from repro_torch.launch.mesh import ClusterContext, cluster_data_axis
from repro_torch.storage.meshfeed import MeshFeeder

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

SEQ_LEN = 16
STEPS = 4


def _session(processes=1, **kw):
    return demo_session_factory(processes=processes, steps=STEPS, seq_len=SEQ_LEN,
                                device="cpu", **kw)


@pytest.fixture
def few_threads(monkeypatch):
    """Workers inherit the environment: two intra-op threads each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


# ---------------------------------------------------------------------------
# custody and feeding, in one process
# ---------------------------------------------------------------------------


def test_with_cluster_upgrades_default_storage():
    spec = FleetSpec.demo(3).with_cluster(processes=2)
    assert spec.cluster == ClusterSpec(processes=2)
    assert spec.storage.backend == "meshfeed"         # synthetic auto-upgrades
    flash = FleetSpec.demo(3).with_storage("flash").with_cluster(processes=2)
    assert flash.storage.backend == "flash"           # explicit choice kept
    assert FleetSpec.demo(3).with_storage("meshfeed").storage.backend == "meshfeed"


@pytest.mark.parametrize("pid", [0, 1])
def test_process_custody_equals_the_reference(pid):
    """A worker of a 2-process cluster provisions devices for its own
    groups only; the others are ``remote`` records.  Manifest records,
    workers and row span equal the reference session's for the same
    process (which builds no mesh for this)."""
    cfg = jax_smoke_config("deepseek-7b")
    jspec = JFleetSpec.demo(n_csds=3).with_cluster(processes=2)
    js = JSession(model=jax_get_model(cfg), optimizer=jax_adamw(), fleet=jspec,
                  data=JDataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN),
                  shards=jspec.shards(private_per_worker={"csd": 64}, public=4096),
                  config=JSessionConfig(total_steps=STEPS))
    js.attach_cluster(JClusterContext(process_id=pid, n_processes=2, mode="hostsync"))
    s = _session(processes=2)
    s.attach_cluster(ClusterContext(process_id=pid, n_processes=2, device=s.device))
    got, want = s.place(), js.place()
    key = lambda d: (d.worker, d.backend, d.custody, d.n_samples, d.process)  # noqa: E731
    assert [key(d) for d in got.devices] == [key(d) for d in want.devices]
    assert [key(d) for d in got.local_devices()] == [key(d) for d in want.local_devices()]
    assert (got.n_processes, got.local_process) == (want.n_processes, want.local_process) == (2, pid)
    assert s.process_map().local_workers(pid) == js.process_map().local_workers(pid)
    assert len(s.devices) == 2 and all(s.devices.is_local(w) for w in s.devices.workers)
    # remote groups' rows stay zero in this process's host batch; the feed
    # lands only this process's span
    R, ml = s.tune().schedule.global_rows, s.tune().schedule.max_local
    start, stop = s.process_map().row_span(pid, ml)
    s.shard()
    batch = s.dataset.next_device_batch(s.device)
    assert batch["tokens"].shape == (stop - start, SEQ_LEN)
    r = s.devices.last_receipt
    assert (r.rows_local, r.rows_global, r.local_fraction) == (stop - start, R, 0.5)
    assert r.bytes_put == (stop - start) * SEQ_LEN * 12


def test_feed_receipt_accounts_every_byte():
    s = _session()
    s.shard()
    batch = s.dataset.next_device_batch(s.device)
    receipt = s.devices.last_receipt
    R = s.tune().schedule.global_rows
    assert receipt.rows_local == receipt.rows_global == R
    assert receipt.local_fraction == 1.0
    # tokens i32 + labels i32 + loss_mask f32, every row put exactly once
    assert receipt.bytes_put == R * SEQ_LEN * 12 and receipt.n_puts == 3
    assert receipt.devices == (0,)
    assert batch["tokens"].shape == (R, SEQ_LEN)


def test_feed_rejects_rows_outside_custody_and_several_devices():
    feeder = MeshFeeder()
    feeder.adopt(torch.device("cpu"), 8)          # this device holds rows [0, 8)
    with pytest.raises(ValueError, match="outside this host's rows"):
        feeder.feed_addressable({"tokens": np.zeros((4, 4), np.int32)},
                                row_offset=4, global_rows=8)
    # a data axis is the world (one device a process); anything else would put
    # several devices in a process
    with pytest.raises(NotImplementedError, match="item 19"):
        MeshFeeder(data_axis=4)
    with pytest.raises(NotImplementedError, match="item 19"):
        MeshFeeder(data_axis=4, world=2)
    MeshFeeder(data_axis=2, world=2)
    # the spmd mode is ported (tests/test_torch_spmd.py); a process's mesh
    # over several devices is not
    assert ClusterContext(process_id=0, n_processes=2, mode="spmd").mode == "spmd"
    with pytest.raises(NotImplementedError, match="item 19"):
        ClusterContext(process_id=0, n_processes=2).local_mesh(8, data_axis=2)
    assert cluster_data_axis(40, 2, 2) == 2 and cluster_data_axis(12, 8, 2) == 6


def test_meshfeed_copies_exactly_its_span():
    """The feed's transfer guard at run time on the meshfeed route ("meta"
    stands in for the card, as in tests/test_torch_custody_gate.py): rows
    [4, 8) of a global batch of 8 cross, and nothing else."""
    fleet = _session().devices
    fleet._feeder.adopt(torch.device("meta"), 8, span=(4, 8))
    batch = {"tokens": np.arange(32, dtype=np.int32).reshape(8, 4),
             "loss_mask": np.ones((8, 4), np.float32)}
    out = fleet.to_device_batch(batch, torch.device("cpu"), row_span=(4, 8))
    assert out["tokens"].shape == (4, 4) and out["tokens"].device.type == "meta"
    r = fleet.last_receipt
    assert (r.rows_local, r.rows_global, r.bytes_put, r.n_puts) == (4, 8, 4 * 4 * 8, 2)


def test_host_feed_copies_exactly_its_batch():
    """The same guarded copy on the host-delivery route (synthetic
    backend): the whole batch crosses, and no receipt is kept."""
    from repro_torch.api import Session

    s = _session()
    fleet = Session(model=s.model, optimizer=s.optimizer, fleet=FleetSpec.demo(3),
                    data=s.data, shards=s.shards, device="cpu").devices
    assert fleet.spec.backend == "synthetic" and fleet.last_receipt is None
    batch = {"tokens": np.arange(32, dtype=np.int32).reshape(8, 4),
             "loss_mask": np.ones((8, 4), np.float32)}
    out = fleet.to_device_batch(batch, torch.device("meta"))
    assert out["tokens"].shape == (8, 4) and out["loss_mask"].device.type == "meta"
    assert fleet.last_receipt is None


def test_attach_cluster_guards():
    from repro_torch.api import Session

    s = _session()
    with pytest.raises(ValueError, match="meshfeed"):
        Session(model=s.model, optimizer=s.optimizer, fleet=FleetSpec.demo(3),
                data=s.data, shards=s.shards, device="cpu").attach_cluster(
            ClusterContext(process_id=0, n_processes=2))
    s.tune()
    s.place()
    with pytest.raises(RuntimeError, match="before any stage"):
        s.attach_cluster(ClusterContext(process_id=0, n_processes=2))
    with pytest.raises(SystemExit):
        train_driver.main(["--device", "cpu", "--cluster-processes", "2",
                           "--cluster-local-devices", "2"])


def test_train_driver_runs_the_cluster_through_run_cluster(monkeypatch, capsys):
    """``launch/train.py --cluster-processes 2`` hands its session factory
    and arguments to ``run_cluster`` and fails when a worker fails (the
    launch itself is the tests below)."""
    from repro_torch.launch import cluster

    calls = []

    def fake(spec, factory, kwargs, **kw):
        calls.append((spec, factory, kwargs))
        rec = {"process": 0, "n_processes": 2, "mode": "hostsync", "local_workers": ["csd/0"],
               "device": "cpu", "receipt": {"rows_local": 20}, "global_rows": 40,
               "compile_count": 1, "param_digest": "d", "losses": [2.0, 1.0],
               "addressable_only": True}
        return cluster.ClusterResult(records=[rec, {**rec, "process": 1}],
                                     returncodes=[0, len(calls) - 1], run_dir="run")

    monkeypatch.setattr(cluster, "run_cluster", fake)
    argv = ["--device", "cpu", "--cluster-processes", "2", "--csds", "3", "--steps", "4",
            "--seq", "16"]
    assert train_driver.main(argv) == 0
    spec, factory, kwargs = calls[0]
    assert spec == ClusterSpec(processes=2)
    assert factory == "repro_torch.launch.train:train_session_factory"
    assert (kwargs["cluster_processes"], kwargs["csds"], kwargs["steps"], kwargs["seq"],
            kwargs["device"]) == (2, 3, 4, 16, "cpu")
    assert "[proc 1/2 hostsync]" in capsys.readouterr().out
    assert train_driver.main(argv) == 1                  # a worker's non-zero return code
    assert "cluster failed" in capsys.readouterr().err


def test_coordinated_checkpoint_equals_the_reference(tmp_path):
    """Two processes' ``ClusterCheckpointManager.save`` (the primary writes
    every leaf between the two barriers) publish the same files, bytes and
    manifest as the reference's ``save_process`` / ``finalize_process_save``
    on the same values, bf16 leaves included; the port restores it; a peer
    lost at the first barrier leaves nothing published."""
    import ml_dtypes

    from repro_torch.launch.transport import SyncPeerLost

    class Barriers:
        def __init__(self, lost=False):
            self.tags, self.lost = [], lost

        def barrier(self, tag):
            if self.lost:
                raise SyncPeerLost(f"peer lost at {tag}")
            self.tags.append(tag)

    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(4, 3, generator=g),
                       "b": torch.randn(5, generator=g).to(torch.bfloat16)}}
    np_tree = {"params": {"w": tree["params"]["w"].numpy(),
                          "b": tree["params"]["b"].float().numpy().astype(ml_dtypes.bfloat16)}}
    meta = {"step": 2, "cursors": {"csd/0": 3}}
    syncs = [Barriers(), Barriers()]
    for pid in (1, 0):
        ClusterCheckpointManager(str(tmp_path / "port"), process_index=pid, num_processes=2,
                                 sync=syncs[pid]).save(2, tree, meta)
    assert syncs[0].tags == syncs[1].tags == ["ckpt-enter/2", "ckpt-publish/2"]
    for pid in (1, 0):
        JM.save_process(str(tmp_path / "ref"), 2, np_tree, process_index=pid,
                        num_processes=2, metadata=meta)
    JM.finalize_process_save(str(tmp_path / "ref"), 2, num_processes=2)
    port, ref = tmp_path / "port" / "step_0000000002", tmp_path / "ref" / "step_0000000002"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    got, m = restore(str(tmp_path / "port"), tree)
    assert m == meta and torch.equal(got["params"]["b"], tree["params"]["b"])
    with pytest.raises(SyncPeerLost):
        ClusterCheckpointManager(str(tmp_path / "torn"), process_index=0, num_processes=2,
                                 sync=Barriers(lost=True)).save(1, tree)
    assert latest_step(str(tmp_path / "torn")) is None

    sync = Barriers()
    ClusterCheckpointManager(str(tmp_path / "one"), process_index=0, num_processes=1,
                             sync=sync).save(3, tree)
    assert latest_step(str(tmp_path / "one")) == 3 and sync.tags == []


def test_params_digest_equals_the_reference():
    import jax.numpy as jnp
    import ml_dtypes

    from repro.launch.cluster import _params_digest as jax_digest

    g = torch.Generator().manual_seed(1)
    tree = {"z": torch.randn(3, generator=g), "a": {"y": torch.randn(2, 2, generator=g),
                                                    "b": torch.randn(4, generator=g)}}
    tree["a"]["b"] = tree["a"]["b"].to(torch.bfloat16)
    jtree = {"z": jnp.asarray(tree["z"].numpy()),
             "a": {"y": jnp.asarray(tree["a"]["y"].numpy()),
                   "b": jnp.asarray(tree["a"]["b"].float().numpy().astype(ml_dtypes.bfloat16))}}
    assert _params_digest(tree) == jax_digest(jtree)


# ---------------------------------------------------------------------------
# real worker processes
# ---------------------------------------------------------------------------


def _launch(tmp_path, name, transport, resume_steps):
    coord = ClusterCoordinator(
        ClusterSpec(processes=2, transport=transport),
        "repro_torch.launch.cluster:demo_session_factory",
        {"processes": 2, "steps": STEPS, "seq_len": SEQ_LEN, "device": "cpu"},
        run_dir=str(tmp_path / name),
    )
    coord.launch(resume_steps=resume_steps)
    try:
        result = coord.wait(timeout=240)
    finally:
        coord.close()
    assert result.ok, (result.returncodes, coord.tail_logs())
    return [result.record(p) for p in range(2)]


def test_two_process_run_equals_the_single_process_session(tmp_path, few_threads):
    recs = _launch(tmp_path, "star", TransportSpec(), resume_steps=2)
    single = _session().run()
    want = [h["loss"] for h in single.history]
    for rec in recs:
        assert rec["mode"] == "hostsync" and rec["n_processes"] == 2
        np.testing.assert_allclose(rec["losses"], want, rtol=1e-5)
        assert rec["addressable_only"]
        assert rec["receipt"]["rows_local"] * 2 == rec["receipt"]["rows_global"] == rec[
            "global_rows"]
        assert rec["receipt"]["local_fraction"] == 0.5
        assert len(rec["local_workers"]) == len(rec["remote_workers"]) == 2
        assert sorted(rec["manifest_local"]) == sorted(rec["local_workers"])
        assert rec["drift_no_recompile"] and rec["compile_count"] == 1
        # the continuation after the drift re-tune runs to total_steps + 2
        # from its own step 0, as the reference's worker does
        assert len(rec["resumed_losses"]) == STEPS + 2
        assert rec["transport"]["topology"] == "star"
        assert rec["transport"]["steps"] == rec["step_split"]["steps"] == 2 * STEPS + 2
    assert recs[0]["param_digest"] == recs[1]["param_digest"]
    assert recs[0]["losses"] == recs[1]["losses"]
    assert set(recs[0]["local_workers"]).isdisjoint(recs[1]["local_workers"])


def test_two_process_run_under_the_production_transport(tmp_path, few_threads):
    recs = _launch(tmp_path, "production", TransportSpec.production(), resume_steps=0)
    single = _session().run()
    for rec in recs:
        t = rec["transport"]
        assert t["topology"] == "ring" and t["spec"]["compression"] == "int8"
        assert t["compression_ratio"] > 3.0
        # the step-1 loss is read from raw sums: compression cannot move it
        np.testing.assert_allclose(rec["losses"][0], single.history[0]["loss"], rtol=1e-5)
        assert all(np.isfinite(rec["losses"]))
    assert recs[0]["param_digest"] == recs[1]["param_digest"]
    assert recs[0]["losses"] == recs[1]["losses"]


def test_elastic_kill_replan_restore_rejoin(tmp_path, few_threads):
    """Kill one worker process of a live 2-process cluster after its first
    coordinated checkpoint: the survivor exits with ``SyncPeerLost`` (no
    hang), the membership watcher turns the death into ``WorkerLost`` for
    the killed process's workers, ``session.apply`` replans, the
    checkpoint restores onto the replanned session, and a join grows it
    back.  The reference's own test of this path fails in this repo's runs;
    its assertions are the ones held here."""
    ckpt = str(tmp_path / "ckpt")
    coord = ClusterCoordinator(
        ClusterSpec(processes=2, transport=TransportSpec(timeout=60.0)),
        "repro_torch.launch.cluster:demo_session_factory",
        {"processes": 2, "steps": 100000, "seq_len": SEQ_LEN, "device": "cpu",
         "checkpoint_dir": ckpt, "checkpoint_every": 2},
        run_dir=str(tmp_path / "run"),
    )
    coord.launch(resume_steps=0)
    try:
        watcher = MembershipWatcher(DirMembershipSource(coord.membership_dir, stale_after=1.5))
        live = watcher.wait_for(2, timeout=120)
        lost_workers = set(live["proc-1"].workers)
        assert len(lost_workers) == 2                 # 4 groups, 2 a process

        deadline = time.time() + 120
        while latest_step(ckpt) is None:              # a coordinated save landed
            assert time.time() < deadline, "no checkpoint appeared"
            time.sleep(0.2)

        coord.kill_worker(1)                          # SIGKILL: no goodbye
        t0 = time.time()
        codes = [proc.wait(timeout=60) for proc in coord.processes]
        assert time.time() - t0 < 30                  # the survivor did not hang
        assert codes[0] != 0 and codes[1] != 0
        with open(os.path.join(coord.run_dir, "log.p0.txt")) as f:
            assert "SyncPeerLost" in f.read()

        event = None
        deadline = time.time() + 30
        while event is None and time.time() < deadline:
            for ev in watcher.events():
                if isinstance(ev, WorkerLost) and set(ev.workers) == lost_workers:
                    event = ev
            time.sleep(0.2)
        assert event is not None, "membership never reported the kill"

        # controller session (full fleet view): replan -> restore -> train
        s = demo_session_factory(processes=1, steps=60, seq_len=SEQ_LEN, device="cpu")
        s.config.checkpoint_dir = ckpt
        assert s.tune().schedule.n_groups == 4
        s.apply(event)
        assert s.tune().schedule.n_groups == 2
        assert all(w not in s.tune().group_workers for w in lost_workers)
        saved = latest_step(ckpt)
        rep = s.run(steps=saved + 2)                  # restores onto the RESIZED plan
        assert rep.start_step == saved and rep.steps_run == 2
        assert np.isfinite(rep.final_loss)

        s.apply(WorkerJoined("csd", 1))
        assert s.tune().schedule.n_groups == 3
        rep2 = s.run(steps=latest_step(ckpt) + 1)
        assert rep2.steps_run == 1 and np.isfinite(rep2.final_loss)
    finally:
        coord.close()
