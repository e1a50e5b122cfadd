"""The ``spmd`` cluster mode on the CPU: two worker processes, one replica a
rank of a ``gloo`` process group, gradients summed by ``dist.all_reduce``.

One module fixture launches, at once, the smoke deepseek-7b (f32, AdamW,
``FleetSpec.demo(3)``, seq 16, 4 steps and 2 more after a drift re-tune)
through 2 ``spmd`` workers and through 2 ``hostsync`` workers of the
port's own socket transport (star, no compression), and a 2-rank script
that resolves sharding plans on the ``spmd`` mesh.  Every rendezvous is a
file store under the test's temporary directory (no fixed port).  Held:

* the ``spmd`` replicas end with equal digests, each rank fed exactly its
  half of the rows;
* their losses equal the reference's ``jit(make_train_step)`` on the global
  batches of the JAX batcher, from the same weights, at rtol 1e-5 (as
  ``tests/test_torch_train.py`` holds the single-process session), and the
  hostsync run's exactly (two ranks add the same two float32 partial sums
  whichever way round);
* ``with_sharding(embed="data")`` at data 2 resolves a ZeRO-3 plan on the
  ``DeviceMesh`` (the embedding table cut 2 ways; its training is
  ``tests/test_torch_zero.py``);
* ``ClusterContext.detect`` picks ``hostsync`` on CPU devices, wherever
  the workers outnumber the cards or a worker is not on a card of its own,
  and wherever the plan is resolved over a ``model`` axis (the cluster's
  mesh keeps ``model = 1``; tensor parallelism is
  ``tests/test_torch_tensor_parallel.py``'s); a plan that shards weights over ``data`` (the
  full-width deepseek-7b's ``fsdp`` rules at world 2) runs ``spmd``.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.api import Session as JSession
from repro.api import SessionConfig as JSessionConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro.optim.schedules import goyal_schedule as jax_goyal
from repro.storage import DataConfig as JDataConfig
from repro.train import steps as JS
from repro_torch.core.topology import ClusterSpec, TransportSpec
from repro_torch.launch.cluster import ClusterCoordinator, demo_session_factory
from repro_torch.launch.mesh import ClusterContext

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_LEN, STEPS, RESUME = 16, 4, 2
TIMEOUT = 240

PLAN_SIDE = r"""
import datetime, json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, io = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + io + "/plan-store", rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=60))
from repro_torch.launch.cluster import demo_session_factory
from repro_torch.launch.mesh import ClusterContext

out = {}
for name, rules in (("default", {}), ("fsdp", {"embed": "data"})):
    s = demo_session_factory(processes=2, steps=2, seq_len=16, device="cpu")
    s.sharding_overrides = rules
    s.attach_cluster(ClusterContext(rank, 2, mode="spmd", device=s.device))
    plan = s.shard()
    out[name] = {"plan": plan.describe(), "mesh": str(plan.mesh),
                 "rows": list(s.devices._feeder._span), "zero3": s.zero3() is not None,
                 "table": plan.params["embedding"]["table"].n_shards}
with open(io + f"/plan{rank}.json", "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _coordinator(tmp_path, mode):
    return ClusterCoordinator(
        ClusterSpec(processes=2, transport=TransportSpec(), mode=mode),
        "repro_torch.launch.cluster:demo_session_factory",
        {"processes": 2, "steps": STEPS, "seq_len": SEQ_LEN, "device": "cpu"},
        run_dir=str(tmp_path / mode),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> ({mode: [record of process 0, of process 1]}, [plan results a rank])."""
    import json

    tmp = tmp_path_factory.mktemp("spmd")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"          # the workers inherit it
    coords = {mode: _coordinator(tmp, mode) for mode in ("spmd", "hostsync")}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    plans = []
    try:
        for coord in coords.values():
            coord.launch(resume_steps=RESUME)
        plans = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(PLAN_SIDE), str(r),
                                   str(tmp)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in plans]
        results = {mode: coord.wait(timeout=TIMEOUT) for mode, coord in coords.items()}
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
        for coord in coords.values():
            coord.close()
        for p in plans:
            if p.poll() is None:
                p.kill()
    for p, log in zip(plans, logs):
        assert p.returncode == 0, log[-3000:]
    for mode, res in results.items():
        assert res.ok, (mode, res.returncodes, coords[mode].tail_logs())
    recs = {mode: [res.record(p) for p in range(2)] for mode, res in results.items()}
    plan_out = []
    for r in range(2):
        with open(tmp / f"plan{r}.json") as f:
            plan_out.append(json.load(f))
    return recs, plan_out


def test_spmd_replicas_agree_and_each_rank_lands_its_half(runs):
    recs = runs[0]["spmd"]
    for rec in recs:
        assert (rec["mode"], rec["backend"], rec["world_size"]) == ("spmd", "gloo", 2)
        assert "'data': 2, 'model': 1" in rec["plan"] and "data_axis=2" in rec["plan"]
        assert rec["addressable_only"] and rec["receipt"]["local_fraction"] == 0.5
        assert rec["receipt"]["rows_local"] * 2 == rec["receipt"]["rows_global"] == \
            rec["global_rows"]
        assert rec["transport"] is None                       # no socket wire
        assert rec["drift_no_recompile"] and rec["compile_count"] == 1
        assert len(rec["resumed_losses"]) == STEPS + RESUME
        assert rec["step_split"]["steps"] == 2 * STEPS + RESUME
        assert all(rec["step_split"][k] > 0 for k in ("grad_s", "reduce_s", "apply_s"))
        assert not rec["zero3"] and set(rec["collective_bytes"]) == {"all-reduce"}
    assert recs[0]["param_digest"] == recs[1]["param_digest"]
    assert recs[0]["losses"] == recs[1]["losses"]
    assert set(recs[0]["local_workers"]).isdisjoint(recs[1]["local_workers"])


def test_spmd_equals_the_hostsync_run(runs):
    spmd, host = runs[0]["spmd"], runs[0]["hostsync"]
    assert host[0]["mode"] == "hostsync" and host[0]["backend"] is None
    for a, b in zip(spmd, host):
        assert a["losses"] == b["losses"] and a["resumed_losses"] == b["resumed_losses"]
        assert a["param_digest"] == b["param_digest"]
        assert a["receipt"] == b["receipt"] and a["local_workers"] == b["local_workers"]


def test_spmd_losses_equal_the_reference_train_step(runs):
    """The reference's ``jit(make_train_step)`` over the JAX batcher's
    global batches (its ``Session.run`` fails under jax 0.9, ROADMAP §3),
    from the port's seed-0 weights, with the session's goyal schedule."""
    session = demo_session_factory(processes=1, steps=STEPS, seq_len=SEQ_LEN, device="cpu")
    params, _ = session.init_state(init_opt=False)
    cfg = jax_smoke_config("deepseek-7b")
    jspec = JFleetSpec.demo(n_csds=3)
    js = JSession(model=jax_get_model(cfg), optimizer=jax_adamw(), fleet=jspec,
                  data=JDataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN, seed=0),
                  shards=jspec.shards(private_per_worker={"csd": 64}, public=4096),
                  config=JSessionConfig(total_steps=STEPS))
    sched = jax_goyal(1e-3, js.tune().schedule.valid_rows, base_batch=256, warmup_steps=20,
                      total_steps=STEPS)
    opt = jax_adamw()
    step = jax.jit(JS.make_train_step(js.model, opt, sched))

    def to_jax(tree):
        return ({k: to_jax(v) for k, v in tree.items()} if isinstance(tree, dict)
                else jnp.asarray(tree.numpy()))

    jparams = to_jax(params)
    state = opt.init(jparams)
    want = []
    for _ in range(STEPS):
        b = js.dataset.next_batch()
        jparams, state, m = step(jparams, state, {k: jnp.asarray(b[k]) for k in
                                                  ("tokens", "labels", "loss_mask")})
        want.append(float(m["loss"]))
    for rec in runs[0]["spmd"]:
        np.testing.assert_allclose(rec["losses"], want, rtol=1e-5)


def test_plans_on_the_spmd_mesh(runs):
    """The default plan resolves on the 2-rank ``DeviceMesh`` and each rank
    adopts its half of the rows; ZeRO-3 weights (``embed`` over ``data``)
    at data 2 resolve too, the embedding table cut 2 ways, and make the
    session ZeRO-3."""
    for rank, out in enumerate(runs[1]):
        for name in ("default", "fsdp"):
            assert out[name]["plan"] == "ShardingPlan(mesh={'data': 2, 'model': 1}, " \
                                        "rows=40, data_axis=2)"
            assert "DeviceMesh" in out[name]["mesh"]
            assert out[name]["rows"] == [20 * rank, 20 * (rank + 1)]
        assert (out["default"]["zero3"], out["default"]["table"]) == (False, 1)
        assert (out["fsdp"]["zero3"], out["fsdp"]["table"]) == (True, 2)


def test_plans_without_a_process_group_keep_weights_whole():
    """A hostsync worker's compute plan is its own device, so ZeRO-3 rules
    do not refuse there (its global plan is the feed's contract); a
    single-process session resolves the full-width deepseek-7b's ``fsdp``
    rules on its one device."""
    from repro_torch.api import FleetSpec, Session
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.storage import DataConfig

    s = demo_session_factory(processes=2, steps=2, seq_len=SEQ_LEN, device="cpu")
    s.sharding_overrides = {"embed": "data"}
    s.attach_cluster(ClusterContext(0, 2, mode="hostsync", device=s.device))
    assert s.shard().data_axis == 2 and s._local_plan.n_devices == 1
    cfg = get_config("deepseek-7b")
    spec = FleetSpec.demo(3)
    plan = Session(model=get_model(cfg), optimizer=adamw(), fleet=spec,
                   data=DataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN),
                   shards=spec.shards(public=4096), device="cpu").shard()
    assert cfg.fsdp and plan.rules["embed"] == "data" and plan.n_devices == 1
    emb = plan.params["embedding"]["table"]                  # ("vocab", "embed")
    assert emb.spec == ("model", "data") and emb.n_shards == 1
    assert plan.describe() == "ShardingPlan(mesh={'data': 1, 'model': 1}, rows=40, data_axis=1)"


@pytest.fixture(scope="module")
def smoke_session():
    return demo_session_factory(processes=2, steps=2, seq_len=SEQ_LEN, device="cpu")


@pytest.mark.parametrize("device, pid, n, cards, want", [
    ("cpu", 0, 2, None, "hostsync"),
    ("cpu", 0, 1, None, "hostsync"),
    ("cuda:0", 0, 2, 1, "hostsync"),       # two workers would share the card
    ("cuda:0", 0, 4, 2, "hostsync"),
    ("cuda:0", 0, 2, 2, "spmd"),
    ("cuda:1", 1, 2, 2, "spmd"),
    ("cuda:0", 1, 2, 2, "hostsync"),       # worker 1 on worker 0's card
    ("cuda", 0, 2, 2, "hostsync"),         # bound to no card
    ("cuda:0", 0, 1, 1, "spmd"),
])
def test_detect_picks_spmd_only_with_a_card_a_worker(device, pid, n, cards, want, capsys,
                                                      smoke_session):
    ctx = ClusterContext.detect(pid, n, device=torch.device(device), n_cards=cards,
                                plan=smoke_session.spmd_plan(n))
    assert ctx.mode == want
    assert f"mode {want}" in capsys.readouterr().out


def test_detect_needs_a_plan_that_keeps_every_leaf_whole(capsys, smoke_session):
    """Workers bound a card each run ``spmd`` where the plan keeps every
    leaf whole or shards it over ``data`` (ZeRO-3: the full-width
    deepseek-7b's ``fsdp`` rules at world 2, the smoke config under
    ``embed="data"``), and ``hostsync`` where it is resolved over a
    ``model`` axis (the cluster's mesh keeps ``model = 1``, as the
    reference's; tensor parallelism runs on ``make_host_mesh``), where two
    workers share a card, or with no plan at all."""
    from repro_torch.api import FleetSpec, Session
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ProcessMesh
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.storage import DataConfig
    from repro_torch.train.steps import build_sharding_plan

    cfg = get_config("deepseek-7b")
    spec = FleetSpec.demo(3)
    full = Session(model=get_model(cfg), optimizer=adamw(), fleet=spec,
                   data=DataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN),
                   shards=spec.shards(public=4096), device="cpu")
    plan = full.spmd_plan(2)
    assert cfg.fsdp and plan.params["embedding"]["table"].n_shards == 2
    rules = smoke_session.sharding_overrides
    smoke_session.sharding_overrides = {**rules, "embed": "data"}
    try:
        sharded = smoke_session.spmd_plan(2)
    finally:
        smoke_session.sharding_overrides = rules
    for p in (plan, sharded):
        for rank in range(2):
            ctx = ClusterContext.detect(rank, 2, device=torch.device("cuda", rank), n_cards=2,
                                        plan=p)
            assert ctx.mode == "spmd" and "ZeRO-3" in capsys.readouterr().out
        ctx = ClusterContext.detect(1, 2, device=torch.device("cuda", 0), n_cards=1, plan=p)
        assert ctx.mode == "hostsync" and "1 card(s)" in capsys.readouterr().out
    tp = build_sharding_plan(smoke_session.model, adamw(),
                             mesh=ProcessMesh(torch.device("cpu"), (1, 2)), global_rows=40,
                             seq_len=SEQ_LEN)
    ctx = ClusterContext.detect(0, 2, device=torch.device("cuda", 0), n_cards=2, plan=tp)
    out = capsys.readouterr().out
    assert ctx.mode == "hostsync"
    assert "model axis of 2" in out and "keeps model = 1" in out
    assert ClusterContext.detect(0, 2, device=torch.device("cuda", 0), n_cards=2).mode == \
        "hostsync"
    assert "no plan to check" in capsys.readouterr().out


def test_allreduce_tree_takes_strided_leaves(tmp_path):
    """The spmd step's gradient reduction on a 1-rank ``gloo`` group: a
    strided leaf (as a kernel's backward on the card hands back; NCCL
    refuses one, "Tensors must be contiguous") is reduced as a dense copy, a
    dense leaf in place, and the tree keeps its structure and values."""
    import datetime

    import torch.distributed as dist

    from repro_torch.train.steps import allreduce_tree

    rng = np.random.default_rng(26)
    wide = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    dense = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    tree = {"b": {"w": wide.t()}, "a": dense}
    assert not tree["b"]["w"].is_contiguous()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        out = allreduce_tree(tree)
    finally:
        dist.destroy_process_group()
    assert list(out) == ["b", "a"] and out["a"] is dense
    assert out["b"]["w"].is_contiguous() and torch.equal(out["b"]["w"], wide.t())
