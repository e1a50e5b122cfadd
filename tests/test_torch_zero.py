"""ZeRO-3 over the ``data`` axis (the configs' ``fsdp=True``) in the ``spmd``
mode, on the CPU: each rank holds its shard of every parameter and AdamW
moment that carries ``embed``, gathers a layer's weights where the layer
runs (again in the backward's recompute) and gets their gradients back
reduce-scattered (``repro_torch.distributed.zero``).

One module fixture launches every run at once, each rendezvous a file store
under the test's temporary directory:

* four processes; first two of them as a world-2 ``gloo`` group: the smoke
  deepseek-7b under
  ``fsdp=True`` and as published (replicated) through ``WorkerRuntime``
  (f32, AdamW, ``FleetSpec.demo(3)``, seq 16, 4 steps); a ZeRO-3 session
  fed the whole seed-0 tree (cut to its shards on adoption); the checkpoint
  runs (2 steps saved at step 2; a fresh session resumed from it for 2
  more);
  qwen3-moe and rwkv6 sessions (2 steps) under ``fsdp=True`` and
  replicated, and two ``make_spmd_train_step`` steps both ways, of
  qwen2-vl with ``patch_embeds`` and of deepseek-7b in bf16; then all four
  as a world-4 group:
  deepseek-7b under ``fsdp=True`` and replicated;
* the reference on four fake CPU devices: its ``build_sharding_plan``'s
  ``NamedSharding.shard_shape`` for every leaf at data 2 and 4 (the four
  smoke configs under ``fsdp=True``, and the eight published ``fsdp``
  configs on abstract shapes), and its ``save_process`` /
  ``finalize_process_save`` of a dp=2-sharded f32 training state (two
  processes' views of the two devices: each saves the shards on its own
  device, as a two-process run would see them).

Held: ZeRO-3 at world 2 equals the replicated run bit for bit (two float32
partials add the same either way round), at world 4 within rtol 1e-6, and
both equal the reference's ``jit(make_train_step)`` within rtol 1e-5; the
shard shapes equal the reference's; the step's collective bytes equal the
closed form of the design and the reference's ring accounting; checkpoints
save at world 2 and restore at worlds 1 and 4 bit for bit, a resumed run
equals the uninterrupted one, and each package reads the other's chunked
checkpoint.
"""
import json
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
from repro.checkpoint import manager as JM
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro.optim.optimizers import OptState as JOptState
from repro.optim.schedules import goyal_schedule as jax_goyal
from repro.roofline.collectives import collective_bytes_from_hlo
from repro.storage import DataConfig as JDataConfig
from repro.train import steps as JS
from repro_torch.checkpoint import restore
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.interop import from_rank_shards, rank_shards
from repro_torch.launch.cluster import demo_session_factory
from repro_torch.models.api import get_model
from repro_torch.models.param import keeping
from repro_torch.optim import adamw
from repro_torch.roofline.collectives import KINDS, collective_bytes
from repro_torch.train.steps import build_sharding_plan

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_LEN, STEPS = 16, 4
TIMEOUT = 240
SMOKE_ARCHS = ("deepseek-7b", "qwen3-moe-30b-a3b", "rwkv6-7b", "qwen2-vl-7b")
FSDP_ARCHS = ("deepseek-7b", "deepseek-coder-33b", "minitron-8b", "qwen1.5-4b",
              "qwen2-vl-7b", "qwen3-moe-30b-a3b", "rwkv6-7b", "dbrx-132b")
ROWS = 40                      # FleetSpec.demo(3)'s global rows

RANK_SIDE = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
rank, io = int(sys.argv[1]), sys.argv[2]
from repro_torch.configs import smoke_config
from repro_torch.distributed import zero
from repro_torch.interop import rank_shards
from repro_torch.launch.cluster import WorkerRuntime, _params_digest, demo_session_factory
from repro_torch.launch.mesh import ClusterContext, make_host_mesh
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_map
from repro_torch.train.steps import build_sharding_plan, make_spmd_train_step

STEPS, SEQ = 4, 16
FACTORY = "repro_torch.launch.cluster:demo_session_factory"


def session(arch="deepseek-7b", fsdp=True, **kw):
    s = demo_session_factory(processes=world, steps=STEPS, seq_len=SEQ, device="cpu",
                             arch=arch, fsdp=fsdp, **kw)
    s.attach_cluster(ClusterContext(rank, world, mode="spmd", device=s.device))
    return s


def gathered(s, params):
    z = s.zero3()
    return params if z is None else zero.gathered_tree(params, z[0],
                                                       s.shard().mesh.get_group("data"))


def trained(s, **kw):
    rep = s.run(**kw)
    return {"losses": [h["loss"] for h in rep.history],
            "digest": _params_digest(gathered(s, rep.params)),
            "ops": [list(op) for op in s.step_collectives]}


def worker(fsdp):
    return WorkerRuntime(process_id=rank, num_processes=world, sync_address=None,
                         membership_dir=None, factory=FACTORY,
                         factory_kwargs={"processes": world, "steps": STEPS, "seq_len": SEQ,
                                         "device": "cpu", "fsdp": fsdp},
                         mode="spmd").run(resume_steps=0)


def join(world):
    dist.init_process_group("gloo", init_method=f"file://{io}/store-{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))


def leave(name, out):
    with open(f"{io}/{name}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if rank < 2:
    world = 2
    join(world)
    out = {}
    out["zero"], out["replicated"] = worker(True), worker(False)
    s = session()
    whole, _ = s.model.init_params(seed=0, device="cpu")
    out["adopted"] = trained(s, params=whole)
    # checkpoints: 2 steps saved at step 2; a fresh session resumed from it
    # for the other 2 (the uninterrupted run is the worker's above)
    s = session(checkpoint_dir=f"{io}/ckpt", checkpoint_every=2)
    rep = s.run(steps=2)
    state = {"params": gathered(s, rep.params), "mu": gathered(s, rep.opt_state.mu),
             "nu": gathered(s, rep.opt_state.nu)}
    if rank == 0:
        flat = {}

        def walk(tree, prefix):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{prefix}/{k}")
            else:
                flat[prefix] = tree.numpy()

        for name, tree in state.items():
            walk(tree, name)
        np.savez(f"{io}/state2.npz", **flat)
    out["resumed"] = trained(session(checkpoint_dir=f"{io}/ckpt", checkpoint_every=2))
    for arch in ("qwen3-moe-30b-a3b", "rwkv6-7b"):
        out[arch] = {str(f): trained(session(arch, fsdp=f), steps=2) for f in (True, False)}
    # one make_spmd_train_step each way: qwen2-vl with patch embeddings, and
    # deepseek-7b in bf16 (its shards gathered as bytes)
    rng = np.random.default_rng(27)
    for name, cfg, n_patch in (
            ("qwen2-vl-7b", smoke_config("qwen2-vl-7b").with_(fsdp=True), 4),
            ("bf16", smoke_config("deepseek-7b").with_(fsdp=True, dtype=torch.bfloat16), 0)):
        model = get_model(cfg)
        mesh = make_host_mesh(data=world, model=1)
        plan = build_sharding_plan(model, adamw(), mesh=mesh, global_rows=2 * world,
                                   seq_len=8)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2 * world, 8)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab, (2 * world, 8)).astype(np.int32),
                 "loss_mask": (rng.random((2 * world, 8)) < 0.8).astype(np.float32)}
        if n_patch:
            batch["patch_embeds"] = rng.standard_normal(
                (2 * world, n_patch, cfg.d_model)).astype(np.float32)
        mine = {k: torch.from_numpy(v[2 * rank: 2 * rank + 2]) for k, v in batch.items()}
        whole, _ = model.init_params(seed=0, device="cpu")
        group = mesh.get_group("data")
        res = {}
        for kind, lays in (("zero", plan.params), ("replicated", None)):
            p = rank_shards(whole, plan.params if lays is not None else
                            tree_map(lambda t: plan.replicated, whole),
                            rank)
            opt = adamw()
            step = make_spmd_train_step(model, opt, lambda s: torch.tensor(1e-3), timing={},
                                        group=group, layouts=lays)
            state = opt.init(p)
            losses = []
            for _ in range(2):
                p, state, m = step(p, state, mine)
                losses.append(float(m["loss"]))
            full = zero.gathered_tree(p, plan.params, group) if lays is not None else p
            res[kind] = {"losses": losses, "digest": _params_digest(full),
                         "grad_norm": float(m["grad_norm"])}
        out[name] = res
    leave("world2", out)
# then all four ranks (2 and 3 wait at the rendezvous meanwhile)
world = 4
join(world)
leave("world4", {str(fsdp): trained(session(fsdp=fsdp)) for fsdp in (True, False)})
"""

JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax._src import array as jarray
from jax.sharding import Mesh
from repro.checkpoint import manager as JM
from repro.configs import get_config, smoke_config
from repro.models.api import get_model
from repro.optim import adamw
from repro.train.steps import build_sharding_plan

io, smoke, published = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
devs = np.array(jax.devices())
shapes = {}
for kind, archs in (("smoke", smoke), ("published", published)):
    for arch in archs:
        cfg = (smoke_config(arch) if kind == "smoke" else get_config(arch)).with_(fsdp=True)
        m = get_model(cfg)
        abs_params, _ = m.init_params(abstract=True)
        for data in (2, 4):
            mesh = Mesh(devs[:data].reshape(data, 1), ("data", "model"))
            plan = build_sharding_plan(m, adamw(), mesh=mesh, global_rows=40, seq_len=16)
            flat, _ = jax.tree_util.tree_flatten_with_path(plan.params)
            leaves = jax.tree_util.tree_leaves(abs_params)
            shapes[f"{kind}/{arch}/{data}"] = {
                "/".join(str(k.key) for k in path): list(s.shard_shape(tuple(leaf.shape)))
                for (path, s), leaf in zip(flat, leaves)}
with open(io + "/ref_shapes.json", "w") as f:
    json.dump(shapes, f)

# the reference's multi-process save of a dp=2-sharded f32 training state,
# each process's view being the shards on its own device
m = get_model(smoke_config("deepseek-7b").with_(fsdp=True))
mesh = Mesh(devs[:2].reshape(2, 1), ("data", "model"))
plan = build_sharding_plan(m, adamw(), mesh=mesh, global_rows=40, seq_len=16)
abs_params, _ = m.init_params(abstract=True)
rng = np.random.default_rng(2027)
values = jax.tree_util.tree_map(
    lambda a: rng.standard_normal(a.shape).astype(np.float32), abs_params)
state = {"params": values, "opt": adamw().init(values)}
state["opt"] = state["opt"]._replace(step=jnp.int32(9),
                                     mu=jax.tree_util.tree_map(lambda v: v * 0.5, values),
                                     nu=jax.tree_util.tree_map(lambda v: v * v, values))
shardings = {"params": plan.params, "opt": plan.opt}
placed = jax.tree_util.tree_map(lambda v, s: jax.device_put(v, s), state, shardings)
views = {id(a): list(a.addressable_shards) for a in jax.tree_util.tree_leaves(placed)}
here = [0]
jarray.ArrayImpl.is_fully_addressable = property(lambda self: False)
jarray.ArrayImpl.addressable_shards = property(
    lambda self: [s for s in views[id(self)] if s.device.id == here[0]])
for p in (0, 1):
    here[0] = p
    JM.save_process(io + "/ref_ckpt", 9, placed, process_index=p, num_processes=2,
                    metadata={"step": 9})
JM.finalize_process_save(io + "/ref_ckpt", 9, num_processes=2)
np.savez(io + "/ref_values.npz", **{k: np.asarray(v) for k, v in
                                    JM._flatten_with_paths(jax.tree_util.tree_map(
                                        np.asarray, state))})
"""


def _spawn(code, args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (io dir, {part: [per-rank outputs]})."""
    io = str(tmp_path_factory.mktemp("zero"))
    parts = {"world2": 2, "world4": 4}
    procs = [_spawn(JAX_SIDE, [io, json.dumps(SMOKE_ARCHS), json.dumps(FSDP_ARCHS)],
                    {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                     "JAX_PLATFORMS": "cpu"})]
    procs += [_spawn(RANK_SIDE, [str(r), io]) for r in range(4)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]
    out = {}
    for part, n in parts.items():
        out[part] = []
        for r in range(n):
            with open(os.path.join(io, f"{part}.{r}.json")) as f:
                out[part].append(json.load(f))
    return io, out


def _flat(tree, prefix=""):
    """{'a/b': leaf} of a nested dict (the reference's key paths)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _plan(arch, data, published=False):
    cfg = (get_config(arch) if published else smoke_config(arch)).with_(fsdp=True)
    model = get_model(cfg)
    return model, build_sharding_plan(model, adamw(), mesh=SH.ProcessMesh(
        torch.device("cpu"), (data, 1)), global_rows=ROWS, seq_len=SEQ_LEN)


# ---------------------------------------------------------------------------
# training: ZeRO-3 against the replicated spmd run and the reference
# ---------------------------------------------------------------------------


def test_zero3_at_world_2_equals_the_replicated_run_bit_for_bit(runs):
    """The smoke deepseek-7b under ``fsdp=True`` through ``WorkerRuntime``
    (``Session.shard`` on the rank ``DeviceMesh``, ZeRO-3 ``init_state``
    and step): losses and the gathered parameters' digest equal the
    replicated run's, both ranks'; a ZeRO-3 session fed the whole seed-0
    tree cuts it to the same shards ``init_state`` draws."""
    main = runs[1]["world2"]
    for rank, out in enumerate(main):
        z, r = out["zero"], out["replicated"]
        assert (z["mode"], z["backend"], z["zero3"], r["zero3"]) == ("spmd", "gloo", True, False)
        assert z["losses"] == r["losses"] and z["param_digest"] == r["param_digest"]
        assert out["adopted"]["losses"] == z["losses"]
        assert out["adopted"]["digest"] == z["param_digest"]
        assert all(z["step_split"][k] > 0 for k in ("grad_s", "reduce_s", "apply_s"))
    assert main[0]["zero"]["param_digest"] == main[1]["zero"]["param_digest"]


def test_zero3_at_world_4_within_rtol_of_the_replicated_run(runs):
    ranks = runs[1]["world4"]
    for out in ranks:
        np.testing.assert_allclose(out["True"]["losses"], out["False"]["losses"], rtol=1e-6)
    for fsdp in ("True", "False"):
        assert len({out[fsdp]["digest"] for out in ranks}) == 1
        assert len({tuple(out[fsdp]["losses"]) for out in ranks}) == 1


@pytest.fixture(scope="module")
def reference_losses():
    """The reference's ``jit(make_train_step)`` over the JAX batcher's global
    batches (its ``Session.run`` fails under jax 0.9, ROADMAP §3), from the
    port's seed-0 weights, with the session's goyal schedule."""
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
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    state = opt.init(jparams)
    want = []
    for _ in range(STEPS):
        b = js.dataset.next_batch()
        jparams, state, m = step(jparams, state, {k: jnp.asarray(b[k]) for k in
                                                  ("tokens", "labels", "loss_mask")})
        want.append(float(m["loss"]))
    return want


@pytest.mark.parametrize("world", [2, 4])
def test_zero3_equals_the_reference_train_step(runs, reference_losses, world):
    got = [out["zero"]["losses"] for out in runs[1]["world2"]] if world == 2 else \
        [out["True"]["losses"] for out in runs[1]["world4"]]
    for losses in got:
        np.testing.assert_allclose(losses, reference_losses, rtol=1e-5)


def test_moe_under_zero3_equals_the_replicated_run(runs):
    for out in runs[1]["world2"]:
        z, r = out["qwen3-moe-30b-a3b"]["True"], out["qwen3-moe-30b-a3b"]["False"]
        assert z["losses"] == r["losses"] and z["digest"] == r["digest"]
        assert {op[0] for op in z["ops"]} == {"all-gather", "reduce-scatter", "all-reduce"}


def test_rwkv6_under_zero3_equals_the_replicated_run(runs):
    """The recurrent smoke model is chaotic under AdamW
    (``tests/test_torch_recurrent_train.py``): step 1 at rtol 1e-6, the
    later steps at 3e-3."""
    for out in runs[1]["world2"]:
        z, r = out["rwkv6-7b"]["True"], out["rwkv6-7b"]["False"]
        np.testing.assert_allclose(z["losses"][0], r["losses"][0], rtol=1e-6)
        np.testing.assert_allclose(z["losses"][1:], r["losses"][1:], rtol=3e-3)


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "bf16"])
def test_one_step_equals_the_replicated_step(runs, name):
    """``make_spmd_train_step`` on hand-built batches, two steps each way:
    qwen2-vl with patch embeddings in the batch, and the deepseek-7b smoke
    config in bf16, whose shards the gathers move as bytes."""
    for out in runs[1]["world2"]:
        z, r = out[name]["zero"], out[name]["replicated"]
        assert z["losses"] == r["losses"] and z["digest"] == r["digest"]
        np.testing.assert_allclose(z["grad_norm"], r["grad_norm"], rtol=1e-5)


# ---------------------------------------------------------------------------
# layouts, resident bytes and collective bytes
# ---------------------------------------------------------------------------

LAYOUT_CASES = [(kind, arch, data) for kind, archs in (("smoke", SMOKE_ARCHS),
                                                         ("published", FSDP_ARCHS))
                for arch in archs for data in (2, 4)]


@pytest.mark.parametrize("kind, arch, data", LAYOUT_CASES)
def test_shard_shapes_equal_the_reference_plan(runs, kind, arch, data):
    """Every parameter leaf's shard shape on a ``data x 1`` plan equals the
    reference's ``NamedSharding.shard_shape``; the plan passes
    ``check_plan``; every leaf that carries ``embed`` is cut ``data`` ways
    along it, and no other leaf is cut."""
    with open(os.path.join(runs[0], "ref_shapes.json")) as f:
        want = json.load(f)[f"{kind}/{arch}/{data}"]
    model, plan = _plan(arch, data, published=kind == "published")
    abs_params, axes = model.init_params(abstract=True)
    shapes, axes = _flat(abs_params), _flat(axes)
    got = {path: list(lay.shard_shape(tuple(shapes[path].shape)))
           for path, lay in SH.iter_layouts(plan.params)}
    assert got == want
    assert SH.check_plan(plan, data) is plan and SH.is_zero3(plan)
    for path, lay in SH.iter_layouts(plan.params):
        if lay.data_dim is not None:
            assert axes[path][lay.data_dim] == "embed" and lay.n_shards == data
        else:
            assert "embed" not in axes[path] or shapes[path].shape[
                axes[path].index("embed")] % data, path


def test_resident_bytes_are_the_shards(runs):
    """A rank's parameters and moments are exactly its shards: under ZeRO-3
    half the replicated run's, less the norms it keeps whole."""
    model, plan = _plan("deepseek-7b", 2)
    abs_params, _ = model.init_params(abstract=True)
    shapes = _flat(abs_params)
    shard = sum(int(np.prod(lay.shard_shape(tuple(shapes[p].shape)))) * 4
                for p, lay in SH.iter_layouts(plan.params))
    whole = sum(int(np.prod(t.shape)) * 4 for t in shapes.values())
    for out in runs[1]["world2"]:
        z, r = out["zero"], out["replicated"]
        assert (z["param_bytes"], z["moment_bytes"]) == (shard, 2 * shard)
        assert (r["param_bytes"], r["moment_bytes"]) == (whole, 2 * whole)
        assert 0.5 < shard / whole < 0.51


@pytest.mark.parametrize("kind", KINDS)
def test_collective_bytes_equal_the_reference_hlo_accounting(kind):
    """One collective of each kind: the port's count equals the reference's
    ``collective_bytes_from_hlo`` on an HLO line of the same result shape,
    dtype and group size."""
    groups = "source_target_pairs={{0,1},{1,0}}" if kind == "collective-permute" else \
        "replica_groups=[2,4]<=[8]"
    n = 2 if kind == "collective-permute" else 4
    for dtype, width in (("f32", 4), ("bf16", 2)):
        line = (f"  %x = {dtype}[128,1024]{{1,0}} {kind}({dtype}[128,1024]{{1,0}} %y), "
                f"{groups}")
        assert collective_bytes([(kind, 128 * 1024 * width, n)]) == \
            collective_bytes_from_hlo(line)


def test_a_world_2_step_moves_the_closed_form_bytes(runs):
    """The last step's collectives at world 2, n = 2: every sharded leaf
    gathered where it is used (a block leaf twice, the forward and the
    remat recompute; the embedding and the head once), each
    reduce-scattered once in f32, and the replicated leaves' gradients, the
    loss sums and the sharded squared norm all-reduced:

        all-gather      (2 P_blocks + P_top) (n-1)/n
        reduce-scatter  P_sharded (n-1)/n
        all-reduce      2 (P_replicated + 12 + 4) (n-1)/n

    with P the f32 bytes of the leaves; 3 P (n-1)/n for a block leaf."""
    model, plan = _plan("deepseek-7b", 2)
    abs_params, _ = model.init_params(abstract=True)
    shapes = _flat(abs_params)
    n = 2
    gather = rs = ar = 0
    for path, lay in SH.iter_layouts(plan.params):
        p = int(np.prod(shapes[path].shape)) * 4
        if lay.data_dim is None:
            ar += 2 * p * (n - 1) // n
            continue
        gather += (2 if path.startswith("blocks/") else 1) * p * (n - 1) // n
        rs += p * (n - 1) // n
    ar += 2 * (12 + 4) * (n - 1) // n
    want = {"all-gather": gather, "reduce-scatter": rs, "all-reduce": ar}
    for out in runs[1]["world2"]:
        assert out["zero"]["collective_bytes"] == want
        assert collective_bytes(map(tuple, out["zero"]["collective_ops"])) == want
        assert set(out["replicated"]["collective_bytes"]) == {"all-reduce"}


def test_the_init_is_drawn_whole_and_sliced():
    """``keeping`` (what ``Session.init_state`` runs under ZeRO-3) keeps
    each rank's slices, bit for bit those of the whole init, and the slices
    of every rank assemble it."""
    model, plan = _plan("deepseek-7b", 2)
    whole = _flat(model.init_params(seed=5, device="cpu")[0])
    lays = dict(SH.iter_layouts(plan.params))
    pieces = []
    for coord in range(2):
        def keep(path, leaf):
            lay = lays["/".join(path)]
            return leaf if lay.data_dim is None else lay.local(leaf, coord).clone()

        with keeping(keep):
            pieces.append(_flat(model.init_params(seed=5, device="cpu")[0]))
    for path, lay in lays.items():
        assert torch.equal(pieces[0][path], lay.local(whole[path], 0))
        assert torch.equal(lay.assemble([pieces[0][path], pieces[1][path]]), whole[path])
    assert sum(t.numel() for t in pieces[0].values()) < 0.51 * sum(
        t.numel() for t in whole.values())


# ---------------------------------------------------------------------------
# per-shard checkpoints
# ---------------------------------------------------------------------------


def _state_like(model):
    like, _ = model.init_params(abstract=True)
    return {"params": like, "opt": adamw().init(like)}


def _check_state(state, want):
    assert state["opt"].step == 2
    for name, tree in (("params", state["params"]), ("mu", state["opt"].mu),
                       ("nu", state["opt"].nu)):
        for path, t in _flat(tree).items():
            np.testing.assert_array_equal(t.numpy(), want[f"{name}/{path}"])


def test_a_world_2_checkpoint_restores_at_worlds_1_and_4(runs):
    """The chunked checkpoint the two ranks wrote at step 2 restores whole
    (world 1) and as each of four ranks' shards (a data-4 plan) bit for bit
    the gathered state."""
    io = runs[0]
    want = dict(np.load(os.path.join(io, "state2.npz")))
    with open(os.path.join(io, "ckpt", "step_0000000002", "manifest.json")) as f:
        entries = json.load(f)["entries"]
    assert "chunks" in entries["params/blocks/attn/wq"]
    assert "chunks" not in entries["params/blocks/ln1/scale"]
    assert len(entries["opt/mu/embedding/table"]["chunks"]) == 2
    model, plan4 = _plan("deepseek-7b", 4)
    like = _state_like(model)
    whole, meta = restore(os.path.join(io, "ckpt"), like, step=2)
    assert meta["step"] == 2
    _check_state(whole, want)
    layouts = {"params": plan4.params, "opt": plan4.opt}
    ranks = [restore(os.path.join(io, "ckpt"), like, step=2, layouts=layouts, coord=c)[0]
             for c in range(4)]
    for part in ("params", "mu", "nu"):
        trees = [r["params"] if part == "params" else getattr(r["opt"], part) for r in ranks]
        got = _flat(from_rank_shards(trees, plan4.params))
        for path, lay in SH.iter_layouts(plan4.params):
            np.testing.assert_array_equal(got[path].numpy(), want[f"{part}/{path}"])
            assert _flat(trees[1])[path].shape == lay.shard_shape(got[path].shape)


def test_the_resumed_run_equals_the_uninterrupted_one(runs):
    """A fresh ZeRO-3 session on the checkpoint directory resumes at step 2
    (its ranks' shards, the batcher's cursors) and runs steps 3-4 as the
    uninterrupted 4-step run did, bit for bit."""
    for out in runs[1]["world2"]:
        assert out["resumed"]["losses"] == out["zero"]["losses"][2:]
        assert out["resumed"]["digest"] == out["zero"]["param_digest"]


def test_the_reference_restores_the_port_chunked_checkpoint(runs):
    io = runs[0]
    want = dict(np.load(os.path.join(io, "state2.npz")))
    model, _ = _plan("deepseek-7b", 2)
    like = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                                  model.init_params(abstract=True)[0])
    jlike = {"params": like, "opt": JOptState(step=jnp.int32(0), mu=like, nu=like)}
    tree, meta = JM.restore(os.path.join(io, "ckpt"), jlike, step=2)
    assert meta["step"] == 2 and int(tree["opt"].step) == 2
    for name, sub in (("params", tree["params"]), ("mu", tree["opt"].mu),
                      ("nu", tree["opt"].nu)):
        for path, leaf in _flat(sub).items():
            np.testing.assert_array_equal(np.asarray(leaf), want[f"{name}/{path}"])


def test_the_port_restores_the_reference_chunked_checkpoint(runs):
    """The reference's ``save_process`` from two processes' views of a
    dp=2-sharded f32 state: whole, and each rank's shards on a data-2 plan."""
    io = runs[0]
    want = dict(np.load(os.path.join(io, "ref_values.npz")))
    with open(os.path.join(io, "ref_ckpt", "step_0000000009", "manifest.json")) as f:
        entries = json.load(f)["entries"]
    assert [c["file"] for c in entries["params/blocks/attn/wq"]["chunks"]] == \
        ["params__blocks__attn__wq__p0_0.npy", "params__blocks__attn__wq__p1_0.npy"]
    model, plan = _plan("deepseek-7b", 2)
    like = _state_like(model)
    whole, meta = restore(os.path.join(io, "ref_ckpt"), like)
    assert meta["step"] == 9 and whole["opt"].step == 9
    flat = {f"params/{k}": v for k, v in _flat(whole["params"]).items()}
    flat.update({f"opt/mu/{k}": v for k, v in _flat(whole["opt"].mu).items()})
    flat.update({f"opt/nu/{k}": v for k, v in _flat(whole["opt"].nu).items()})
    assert set(flat) | {"opt/step"} == set(want)
    for key, t in flat.items():
        np.testing.assert_array_equal(t.numpy(), want[key])
    layouts = {"params": plan.params, "opt": plan.opt}
    for coord in range(2):
        mine, _ = restore(os.path.join(io, "ref_ckpt"), like, layouts=layouts, coord=coord)
        cut = _flat(rank_shards(whole["params"], plan.params, coord))
        for path, t in _flat(mine["params"]).items():
            assert torch.equal(t, cut[path]), path


# ---------------------------------------------------------------------------
# what the plan, the context and the launcher accept
# ---------------------------------------------------------------------------


def test_a_family_that_gathers_nothing_is_refused_under_zero3():
    """whisper-medium and recurrentgemma-2b (``fsdp=False`` as published)
    gather no shards, so a plan that shards their weights over ``data``
    raises; their replicated plans pass."""
    for arch in ("recurrentgemma-2b", "whisper-medium"):
        s = demo_session_factory(processes=2, steps=2, seq_len=SEQ_LEN, device="cpu", arch=arch)
        s._check_zero3(s.spmd_plan(2))
        s.sharding_overrides = {"embed": "data"}
        plan = s.spmd_plan(2)
        assert SH.is_zero3(plan) and SH.check_plan(plan, 2) is plan
        with pytest.raises(NotImplementedError, match="gathers no shards"):
            s._check_zero3(plan)


def test_the_context_names_its_backend():
    from repro_torch.launch.mesh import ClusterContext

    assert ClusterContext(0, 2, mode="spmd").backend == "gloo"
    assert ClusterContext(0, 2, mode="spmd", device=torch.device("cuda", 0)).backend == "nccl"
    assert ClusterContext(1, 2, mode="spmd", device=torch.device("cuda", 0),
                          backend="gloo").backend == "gloo"     # two ranks share a card
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        ClusterContext(0, 2, mode="spmd", backend="nccl")
    with pytest.raises(ValueError, match="unknown process group backend"):
        ClusterContext(0, 2, mode="spmd", backend="mpi")


def test_the_launcher_names_the_cluster_mode(monkeypatch):
    """``--cluster-mode spmd`` reaches the workers' ``ClusterSpec``; without
    it each worker's ``detect`` picks."""
    from repro_torch.launch import cluster
    from repro_torch.launch import train as T

    seen = []

    def fake_run_cluster(spec, factory, kwargs, **kw):
        seen.append(spec.mode)
        return cluster.ClusterResult(records=[], returncodes=[0], run_dir="")

    monkeypatch.setattr(cluster, "run_cluster", fake_run_cluster)
    for argv, mode in ((["--cluster-mode", "spmd"], "spmd"), ([], None)):
        T.main(["--device", "cpu", "--cluster-processes", "2", "--csds", "3", *argv])
        assert seen.pop() == mode


def test_bf16_shards_round_trip_through_chunks(tmp_path):
    """Two ranks' bf16 shards through ``save_process`` and the primary's
    ``finalize_process_save`` (no process group: the two shares are written
    one after the other): chunked entries named ``bfloat16``, restored whole
    and as each rank's shard bit for bit; a missing share is never
    published."""
    from repro_torch.checkpoint import finalize_process_save, save_process

    model, plan = _plan("deepseek-7b", 2)
    whole, _ = model.init_params(seed=3, device="cpu")
    whole = {k: v for k, v in whole.items() if k in ("embedding", "ln_f")}
    lays = {k: plan.params[k] for k in whole}
    tree = lambda params: {"params": params}                      # noqa: E731
    for coord in range(2):
        bf16 = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
                for k, v in rank_shards(whole, lays, coord).items()}
        save_process(str(tmp_path), 5, tree(bf16), process_index=coord, num_processes=2,
                     layouts=tree(lays), coord=coord, metadata={"step": 5})
    with pytest.raises(FileNotFoundError, match="process 2 never stamped"):
        finalize_process_save(str(tmp_path), 5, num_processes=3)
    finalize_process_save(str(tmp_path), 5, num_processes=2)
    with open(tmp_path / "step_0000000005" / "manifest.json") as f:
        entries = json.load(f)["entries"]
    assert entries["params/embedding/table"]["dtype"] == "bfloat16"
    assert len(entries["params/embedding/table"]["chunks"]) == 2
    assert "file" in entries["params/ln_f/scale"]                 # the primary's, whole
    like = tree({k: {n: t.to(torch.bfloat16) for n, t in v.items()} for k, v in whole.items()})
    got, meta = restore(str(tmp_path), like)
    assert meta["step"] == 5
    for path, t in _flat(got["params"]).items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, _flat(like["params"])[path]), path
    for coord in range(2):
        mine, _ = restore(str(tmp_path), like, layouts=tree(lays), coord=coord)
        want = rank_shards(like["params"], lays, coord)
        for path, t in _flat(mine["params"]).items():
            assert torch.equal(t, _flat(want)[path]), path
