"""The port's distributed library against the JAX package's: the sharding
rule tables, the plan's placements, and the collectives and the GPipe
schedule over ``gloo`` ranks.

The rule functions run in this process on both sides (the reference's
``_divisible_spec`` reads only a mesh's ``shape``).  The plan's placements
are held to the reference's ``arg_shardings_for_tree`` on a fake-device
mesh, in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(as ``tests/test_distributed.py`` runs its JAX side): each leaf's spec and
the shape of one device's piece.  The reference's own sharding-plan tests
(``Session.shard()``) fail in this repo's runs, so its oracle functions are
the reference here.

The collectives run on four CPU processes under ``gloo``, rendezvous at a
``FileStore`` under the test's temporary directory (no port), on the same
numpy inputs (seeded) that the JAX functions get on four fake devices:
``ring_allreduce`` at world 2 (a sub-group) and 4 bit for bit against the
JAX ring (the same hop order and zero padding add the same floats in the
same order) and within 1e-6 of the plain sum; ``hierarchical_allreduce``
on a 2 x 2 mesh, ``compressed_allreduce`` (the port's CPU route, the plain
quantizer: ``q`` and ``scale`` bytes equal to the interpret-mode Pallas
kernel's) and ``pipeline_apply`` at S = 2 and 4, each within rtol 1e-6.
Where a sum cancels or a value sits near zero a relative tolerance alone
cannot hold across two libraries, so those comparisons also take atol 1e-6,
a few float32 ulps at the data's scale (XLA's ``psum`` adds in another
order than ``gloo``'s all-reduce, and XLA's and PyTorch's ``tanh`` differ in
the last bit); the port's pipeline equals its own sequential stages at
rtol 1e-6 alone.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import sharding as JSH
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.distributed import allreduce as AR
from repro_torch.distributed import pipeline as PL
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import ProcessMesh
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train.steps import build_sharding_plan

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _norm(spec):
    """A spec (PartitionSpec or the port's tuple) as JSON-comparable lists;
    a tuple of one axis is that axis (jax 0.9's PartitionSpec folds it)."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e
            for e in tuple(spec)]


# ---------------------------------------------------------------------------
# rule tables, in this process
# ---------------------------------------------------------------------------

RULES = {
    "default": {},
    "fsdp": {"fsdp": True},
    "seq_shard": {"seq_shard": True},
    "ep_over_data": {"extra": {"experts": ("data",), "heads": None}},
}
SPEC_CASES = [
    (("vocab", "embed"), "default"),
    (("batch", "seq"), "default"),
    (("layers", "embed", "mlp"), "default"),
    (("heads", "kv_heads", "head_dim"), "default"),
    (("batch", "embed"), "fsdp"),
    (("embed", "vocab"), "fsdp"),
    (("layers", "embed", "heads", "head_dim"), "fsdp"),
    (("batch", "kv_seq", "act_kv_heads"), "seq_shard"),
    (("batch", "seq"), "seq_shard"),
    (("experts", "embed", "expert_mlp"), "ep_over_data"),
    (("batch", "experts"), "ep_over_data"),
    ((None, "heads", None), "ep_over_data"),
]
DIVISIBLE_CASES = [
    (P(None, "model", None), (4, 56, 128), {"data": 16, "model": 16}),
    (P(None, "model", None), (4, 64, 128), {"data": 16, "model": 16}),
    (P(("pod", "data"), "model"), (8, 64), {"data": 4, "model": 2}),
    (P(("data", "model"),), (12,), {"data": 2, "model": 4}),
    (P(("data", "model"),), (16,), {"data": 2, "model": 4}),
    (P("data", None, "model"), (3, 5, 7), {"data": 1, "model": 1}),
    (P(None, None, "data"), (2, 2), {"data": 2}),
]


@pytest.mark.parametrize("case", [("spec_for", i) for i in range(len(SPEC_CASES))]
                         + [("divisible", i) for i in range(len(DIVISIBLE_CASES))]
                         + [("tree", name) for name in RULES])
def test_rule_tables_equal_the_reference(case):
    kind, i = case
    if kind == "spec_for":
        axes, rules = SPEC_CASES[i]
        got = SH.spec_for(axes, SH.make_rules(**RULES[rules]))
        want = JSH.spec_for(axes, JSH.make_rules(**RULES[rules]))
        assert _norm(got) == _norm(want)
    elif kind == "divisible":
        spec, shape, sizes = DIVISIBLE_CASES[i]
        mesh = ProcessMesh(torch.device("cpu"), tuple(sizes.values()), tuple(sizes))
        got = SH._divisible_spec(tuple(spec), shape, mesh)
        want = JSH._divisible_spec(spec, shape, types.SimpleNamespace(shape=sizes))
        assert _norm(got) == _norm(want)
    else:
        assert SH.make_rules(**RULES[i]) == JSH.make_rules(**RULES[i])
        tree = {"a": ("vocab", "embed"), "b": {"c": ("mlp", "embed"), "d": ("batch", None)}}
        got = SH.specs_for_tree(tree, SH.make_rules(**RULES[i]))
        want = JSH.specs_for_tree(tree, JSH.make_rules(**RULES[i]))
        assert _norm(got["a"]) == _norm(want["a"])
        assert {k: _norm(v) for k, v in got["b"].items()} == \
            {k: _norm(v) for k, v in want["b"].items()}


def test_use_rules_restores_the_table():
    base = SH.get_rules()
    with SH.use_rules(SH.make_rules(fsdp=True)):
        assert SH.get_rules()["embed"] == "data"
    assert SH.get_rules() is base


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_flag_is_the_references(arch):
    assert get_config(arch).fsdp == jax_get_config(arch).fsdp
    assert smoke_config(arch).fsdp == jax_smoke_config(arch).fsdp is False


def test_placements_resolve_specs_on_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    mesh = ProcessMesh(torch.device("cpu"), (2, 4))
    lay = SH.layout_for(SH._divisible_spec(("data", None, "model"), (6, 3, 8), mesh), mesh)
    assert lay.placements == (Shard(0), Shard(2)) and lay.n_shards == 8
    assert lay.shard_shape((6, 3, 8)) == (3, 3, 2)
    lay = SH.layout_for((None, ("data", "model")), mesh)
    assert lay.placements == (Shard(1), Shard(1)) and lay.shard_shape((5, 16)) == (5, 2)
    assert SH.layout_for((), mesh).placements == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# the reference on four fake devices, the port on four gloo ranks
# ---------------------------------------------------------------------------

N_RING = 1037           # not a multiple of 2 or 4: the ring pads
N_HIER = 515
N_COMP = 3 * 4096 + 77  # not a multiple of 256 rows: the quantizer's input pads
PIPE_M, PIPE_MB, PIPE_D = 8, 2, 16
# plan cases: (arch, fsdp, rule overrides, mesh (data, model))
PLAN_CASES = [
    ("deepseek-7b", False, {}, (2, 2)),
    ("deepseek-7b", True, {}, (2, 2)),
    ("deepseek-7b", True, {}, (4, 1)),
    ("qwen3-moe-30b-a3b", True, {}, (1, 4)),
    ("qwen3-moe-30b-a3b", False, {"experts": ("data",)}, (4, 1)),
    ("rwkv6-7b", True, {}, (2, 2)),
    ("recurrentgemma-2b", False, {}, (2, 2)),
    ("whisper-medium", False, {"heads": None}, (1, 4)),
]
PLAN_ROWS, PLAN_SEQ = 8, 16


def _inputs():
    rng = np.random.default_rng(2026)
    f32 = np.float32
    return {
        "ring2": rng.standard_normal((2, N_RING)).astype(f32),
        "ring4": rng.standard_normal((4, N_RING)).astype(f32),
        "hier": rng.standard_normal((2, 2, N_HIER)).astype(f32),
        "cx": rng.standard_normal((4, N_COMP)).astype(f32),
        "cr": (rng.standard_normal((4, N_COMP)) * 1e-2).astype(f32),
        "cn": rng.random((4, N_COMP)).astype(f32),
        "w2": (rng.standard_normal((2, PIPE_D, PIPE_D)) * 0.3).astype(f32),
        "w4": (rng.standard_normal((4, PIPE_D, PIPE_D)) * 0.3).astype(f32),
        "m2": rng.standard_normal((PIPE_M, PIPE_MB, PIPE_D)).astype(f32),
        "m4": rng.standard_normal((PIPE_M, PIPE_MB, PIPE_D)).astype(f32),
    }


JAX_SIDE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import smoke_config
from repro.distributed.allreduce import compressed_allreduce, hierarchical_allreduce, ring_allreduce
from repro.distributed.pipeline import pipeline_apply
from repro.distributed.sharding import arg_shardings_for_tree, make_rules
from repro.kernels import ops as kops
from repro.models.api import get_model
from repro.train.steps import BATCH_AXES, abstract_batch

io, rows, seq = sys.argv[1], int(sys.argv[3]), int(sys.argv[4])
inp = dict(np.load(io + "/inputs.npz"))
devs = np.array(jax.devices())
out = {}
for n in (2, 4):
    mesh = Mesh(devs[:n], ("data",))
    f = shard_map(lambda v: ring_allreduce(v[0], "data")[None], mesh=mesh,
                  in_specs=P("data"), out_specs=P("data"), check_rep=False)
    out[f"ring{n}"] = np.asarray(f(jnp.asarray(inp[f"ring{n}"])))
mesh = Mesh(devs.reshape(2, 2), ("pod", "data"))
f = shard_map(lambda v: hierarchical_allreduce(v[0, 0], intra_axis="data",
                                               inter_axis="pod")[None, None],
              mesh=mesh, in_specs=P("pod", "data"), out_specs=P("pod", "data"),
              check_rep=False)
out["hier"] = np.asarray(f(jnp.asarray(inp["hier"])))
mesh = Mesh(devs, ("data",))
f = shard_map(lambda v, r, nz: tuple(t[None] for t in compressed_allreduce(
                  v[0], r[0], nz[0], axis="data")),
              mesh=mesh, in_specs=(P("data"),) * 3, out_specs=(P("data"), P("data")),
              check_rep=False)
total, res = f(*(jnp.asarray(inp[k]) for k in ("cx", "cr", "cn")))
out["ctotal"], out["cres"] = np.asarray(total), np.asarray(res)
qs, ss = [], []
for d in range(4):    # the reference's quantizer input (allreduce.py:134-143), a device's
    y = jnp.asarray(inp["cx"][d]) + jnp.asarray(inp["cr"][d])
    pad = (-y.shape[0]) % 256
    q, s = kops.quantize_int8(jnp.pad(y, (0, pad)).reshape(256, -1),
                              jnp.pad(jnp.asarray(inp["cn"][d]), (0, pad)).reshape(256, -1),
                              interpret=True)
    qs.append(np.asarray(q))
    ss.append(np.asarray(s))
out["cq"], out["cs"] = np.stack(qs), np.stack(ss)
for S in (2, 4):
    mesh = Mesh(devs[:S], ("stage",))
    out[f"pipe{S}"] = np.asarray(pipeline_apply(
        lambda p, h: jnp.tanh(h @ p["w"]), {"w": jnp.asarray(inp[f"w{S}"])},
        jnp.asarray(inp[f"m{S}"]), mesh=mesh))
np.savez(io + "/jax.npz", **out)

plans = []
for arch, fsdp, extra, (data, model) in json.loads(sys.argv[2]):
    m = get_model(smoke_config(arch).with_(fsdp=fsdp))
    mesh = Mesh(devs[:data * model].reshape(data, model), ("data", "model"))
    rules = make_rules(fsdp=fsdp, extra={k: tuple(v) if isinstance(v, list) else v
                                         for k, v in extra.items()} or None)
    rules.setdefault("seq_data", None)
    params_abs, axes = m.init_params(abstract=True)
    got = {}
    trees = [("params", arg_shardings_for_tree(axes, params_abs, rules, mesh), params_abs),
             ("batch", arg_shardings_for_tree(BATCH_AXES, abstract_batch(rows, seq), rules, mesh),
              abstract_batch(rows, seq))]
    for name, sh, shapes in trees:
        flat, _ = jax.tree_util.tree_flatten_with_path(sh)
        leaves = jax.tree_util.tree_leaves(shapes)
        for (path, s), leaf in zip(flat, leaves):
            key = name + "/" + "/".join(str(k.key) for k in path)
            spec = [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e
                    for e in s.spec]
            got[key] = [spec, list(s.shard_shape(tuple(leaf.shape)))]
    plans.append(got)
with open(io + "/plans.json", "w") as f:
    json.dump(plans, f)
"""

RANK_SIDE = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, io = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + io + "/store", rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.distributed.allreduce import (compressed_allreduce, hierarchical_allreduce,
                                               payload_rows, ring_allreduce)
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh

inp = dict(np.load(io + "/inputs.npz"))
t = lambda k: torch.from_numpy(inp[k])
out = {}
pair = dist.new_group([0, 1])            # every rank takes part in making it
if rank < 2:
    out["ring2"] = ring_allreduce(t("ring2")[rank], pair).numpy()
out["ring4"] = ring_allreduce(t("ring4")[rank]).numpy()
mesh = make_host_mesh(data=2, model=2, axis_names=("pod", "data"))   # [[0, 1], [2, 3]]
p, d = divmod(rank, 2)
out["hier"] = hierarchical_allreduce(t("hier")[p, d], intra_group=mesh.get_group("data"),
                                     inter_group=mesh.get_group("pod")).numpy()
x, r, nz = t("cx")[rank], t("cr")[rank], t("cn")[rank]
total, res = compressed_allreduce(x, r, nz)
q, s = ops.quantize_int8(*payload_rows(x + r, nz))
out.update(ctotal=total.numpy(), cres=res.numpy(), cq=q.numpy(), cs=s.numpy())
stage = lambda prm, h: torch.tanh(h @ prm["w"])
out["pipe4"] = pipeline_apply(stage, {"w": t("w4")}, t("m4")).numpy()
if rank < 2:
    out["pipe2"] = pipeline_apply(stage, {"w": t("w2")}, t("m2"), group=pair).numpy()
np.savez(io + f"/rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(code, args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def both_sides(tmp_path_factory):
    """Run the JAX side (four fake devices) and the port's four gloo ranks
    at once on the same inputs; -> (inputs, jax outputs, per-rank port
    outputs, the JAX plans)."""
    io = str(tmp_path_factory.mktemp("distributed"))
    inp = _inputs()
    np.savez(os.path.join(io, "inputs.npz"), **inp)
    procs = [_spawn(JAX_SIDE, [io, json.dumps(PLAN_CASES), str(PLAN_ROWS), str(PLAN_SEQ)],
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
        assert proc.returncode == 0, log[-3000:]
    ranks = [dict(np.load(os.path.join(io, f"rank{r}.npz"))) for r in range(4)]
    with open(os.path.join(io, "plans.json")) as f:
        plans = json.load(f)
    return inp, dict(np.load(os.path.join(io, "jax.npz"))), ranks, plans


@pytest.mark.parametrize("n", [2, 4])
def test_ring_allreduce_is_the_jax_ring(both_sides, n):
    inp, want, ranks, _ = both_sides
    plain = inp[f"ring{n}"].astype(np.float64).sum(0)
    for r in range(n):
        got = ranks[r][f"ring{n}"]
        assert got.dtype == np.float32 and got.tobytes() == want[f"ring{n}"][r].tobytes(), r
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)


def test_hierarchical_allreduce_equals_the_reference(both_sides):
    inp, want, ranks, _ = both_sides
    for r in range(4):
        p, d = divmod(r, 2)
        np.testing.assert_allclose(ranks[r]["hier"], want["hier"][p, d], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["hier"], inp["hier"].sum((0, 1)), rtol=1e-5, atol=1e-6)


def test_compressed_allreduce_equals_the_reference(both_sides):
    inp, want, ranks, _ = both_sides
    for r in range(4):
        got = ranks[r]
        assert got["cq"].tobytes() == want["cq"][r].tobytes(), r
        assert got["cs"].tobytes() == want["cs"][r].tobytes(), r
        np.testing.assert_allclose(got["ctotal"], want["ctotal"][r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["cres"], want["cres"][r], rtol=1e-6, atol=1e-6)
        # error feedback: y = dequant(q) + residual, the residual under a step
        y = inp["cx"][r] + inp["cr"][r]
        assert np.abs(got["cres"]).max() <= np.abs(y).max() / 127 * 1.01


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_equals_the_reference_and_the_sequential_stages(both_sides, S):
    inp, want, ranks, _ = both_sides
    x = torch.from_numpy(inp[f"m{S}"])
    for s in range(S):
        x = torch.tanh(x @ torch.from_numpy(inp[f"w{S}"][s]))
    for r in range(S):
        np.testing.assert_allclose(ranks[r][f"pipe{S}"], want[f"pipe{S}"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ranks[r][f"pipe{S}"], x.numpy(), rtol=1e-6)
    assert PL.bubble_fraction(S, PIPE_M) == (S - 1) / (PIPE_M + S - 1)
    assert PL.split_microbatches(torch.zeros(PIPE_M * 3, 5), PIPE_M).shape == (PIPE_M, 3, 5)


@pytest.mark.parametrize("i", range(len(PLAN_CASES)))
def test_plan_placements_equal_the_reference(both_sides, i):
    """``build_sharding_plan`` on a (data, model) mesh: every parameter's
    and batch key's spec and one device's piece equal the reference's
    ``arg_shardings_for_tree`` on the same fake-device mesh; the plan's
    data axis and signature; the replicated step counter and metrics."""
    from torch.distributed.tensor import Replicate

    arch, fsdp, extra, (data, model) = PLAN_CASES[i]
    want = both_sides[3][i]
    m = get_model(smoke_config(arch).with_(fsdp=fsdp))
    mesh = ProcessMesh(torch.device("cpu"), (data, model))
    plan = build_sharding_plan(m, adamw(), mesh=mesh, global_rows=PLAN_ROWS,
                               seq_len=PLAN_SEQ, extra_rules=extra or None)
    params_abs, _ = m.init_params(abstract=True)
    got, flat_shapes = {}, {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        else:
            flat_shapes[prefix] = tuple(tree.shape)

    walk(params_abs, "params")
    for path, lay in SH.iter_layouts(plan.params, "params"):
        got[path] = [_norm(lay.spec), list(lay.shard_shape(flat_shapes[path]))]
    for path, lay in SH.iter_layouts(plan.batch, "batch"):
        got[path] = [_norm(lay.spec), list(lay.shard_shape((PLAN_ROWS, PLAN_SEQ)))]
    assert got == want
    assert plan.data_axis == data and plan.signature() == (PLAN_ROWS, data, data * model)
    assert plan.opt.mu is plan.params and plan.opt.step.placements == (Replicate(),) * 2
    assert plan.describe() == (f"ShardingPlan(mesh={{'data': {data}, 'model': {model}}}, "
                               f"rows={PLAN_ROWS}, data_axis={data})")
    # leaves whole, sharded over data (ZeRO-3) or over model (tensor and
    # expert parallelism, every family) run; query heads that the rules keep
    # whole beside leaves split over model (whisper's heads: None) do not
    over_model = any(p.is_shard() and size > 1 for _, lay in SH.iter_layouts(plan.params)
                     for (axis, size), p in zip(lay.mesh_shape, lay.placements)
                     if axis == "model")
    if over_model and (m.cfg.family not in SH.TP_FAMILIES or extra.get("heads", "model") is None):
        with pytest.raises(NotImplementedError, match="second half of ROADMAP item 19"):
            SH.check_plan(plan)
    else:
        assert SH.check_plan(plan, data * model) is plan
        assert SH.is_zero3(plan) == any(lay.data_dim is not None
                                        for _, lay in SH.iter_layouts(plan.params))


def test_flatten_and_bucketize_round_trip():
    g = torch.Generator().manual_seed(5)
    tree = {"z": torch.randn(3, 4, generator=g),
            "a": {"y": torch.randn(7, generator=g).to(torch.bfloat16)}}
    flat, unflatten = AR.flatten_grads(tree)
    assert flat.dtype == torch.float32 and flat.shape == (19,)
    assert torch.equal(flat[:7], tree["a"]["y"].float())      # the reference's leaf order
    back = unflatten(flat)
    assert back["a"]["y"].dtype == torch.bfloat16 and torch.equal(back["z"], tree["z"])
    buckets = AR.bucketize(flat, bucket_bytes=32)
    assert [b.numel() for b in buckets] == [8, 8, 3]
    assert torch.equal(torch.cat(buckets), flat)
