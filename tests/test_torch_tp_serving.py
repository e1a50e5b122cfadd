"""Serving under the ``model`` axis on the CPU: every family's smoke config
served tensor- and expert-parallel on a ``(data, model)`` ``DeviceMesh`` of
``gloo`` ranks (``sharding.use_mesh``) through ``Model.prefill``,
``Model.decode_step``, ``ServeSession.generate`` and, for the recurrent
pair, the batched route (``make_prefill_step`` + ``make_serve_step``),
against the reference's single-device prefill and decode, from one numpy
weight tree (``params_from_jax`` on the port's side, each rank keeping its
pieces).

The configs: deepseek-7b (native and int8 K/V), minitron-8b (2 KV heads:
whole on every rank at ``model`` = 4), qwen3-moe-30b-a3b (expert-parallel),
rwkv6-7b, recurrentgemma-2b (2 query heads: at ``model`` = 4 a padded split
of 1, 1, 0, 0 heads), whisper-medium (with ``frames``) and qwen2-vl-7b
(with ``patch_embeds``), each at meshes (1 x 2), (2 x 2) (each data group
serving its row of the batch) and (1 x 4); and recurrentgemma-2b's
training step at (1 x 4), the indivisible heads' gradients summed over
``model``, against the reference's ``jit(make_train_step)``.

One module fixture launches every run at once: four ranks (the world-2
runs on the first two, then the world-4 runs on all four, each rendezvous a
file store) and one JAX process on four fake CPU devices, which computes the
reference's outputs and the shard shapes of
``arg_shardings_for_tree(cache_logical_axes(), cache, make_rules(), mesh)``.
The int8 decode steps run on each rank's piece of the reference's prefill
cache (tests/test_torch_families.py says why), so the ranks wait for the
reference's file before them.

Tolerances, as tests/test_torch_families.py holds the same paths on one
device: logits and float caches ``atol=1e-4`` and ``rtol=1e-5``; int8 cache
bytes within 1 LSB (at most 1% of them differing) and scales ``rtol=1e-5``;
greedy tokens identical; the training step's loss and gradient norm rtol
1e-5 at the first step and 3e-3 after it (the recurrent models' chaos,
tests/test_torch_tp_families.py).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.roofline.collectives import tp_serve_ops
from repro_torch.train.steps import build_sharding_plan

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
ARCHS = ("deepseek-7b", "minitron-8b", "qwen3-moe-30b-a3b", "rwkv6-7b", "recurrentgemma-2b",
         "whisper-medium", "qwen2-vl-7b")
RECURRENT = ("rwkv6-7b", "recurrentgemma-2b")
CONFIGS = [(arch, "native") for arch in ARCHS] + [("deepseek-7b", "int8")]
MESHES = ((1, 2), (2, 2), (1, 4))
CASES = [(arch, kv, mesh) for arch, kv in CONFIGS for mesh in MESHES]
B, P, CACHE_LEN, N_NEW, N_PATCH = 2, 8, 20, 4, 4
STEPS, LR, ROWS, SEQ = 3, 1e-2, 4, 16
BIASES = ("bias", "b", "bq", "bk", "bv", "bi", "bo", "dec_pos")
ATOL, RTOL = 1e-4, 1e-5


def key(arch, kv, mesh):
    return f"{arch}/{kv}/{mesh[0]}x{mesh[1]}"


def numpy_params(arch, seed=0):
    """A float32 parameter tree of ``arch``'s smoke config with the leaves of
    the reference's abstract init, drawn with numpy: norm scales 1, biases,
    shifts and whisper's position table N(0, 0.1^2), embedding tables
    N(0, 1), RG-LRU's ``lam`` U(2.2, 6.9), every other leaf N(0, 1/fan_in)
    over the axes it contracts (as tests/test_torch_tp_families.py)."""
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models.api import get_model as jax_get_model

    abstract, _ = jax_get_model(jax_smoke_config(arch)).init_params(abstract=True)
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "scale":
            return np.ones(shape)
        if name in BIASES:
            return 0.1 * rng.standard_normal(shape)
        if name == "table":
            return rng.standard_normal(shape)
        if name == "lam":
            return rng.uniform(2.2, 6.9, shape)
        fan_in = shape[1] * (shape[2] if name == "wo" and len(shape) == 4 else 1)
        return rng.standard_normal(shape) / np.sqrt(fan_in)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v.shape).astype(np.float32)
                for k, v in node.items()}

    return walk(abstract)


def serve_inputs(arch, seed=11):
    """The prompt (B, P), the teacher-forced decode tokens (B, N_NEW), and
    whisper's frames or qwen2-vl's N_PATCH patch embeddings."""
    cfg = smoke_config(arch)
    rng = np.random.default_rng(seed)
    out = {"prompt": rng.integers(0, cfg.vocab, (B, P)).astype(np.int32),
           "forced": rng.integers(0, cfg.vocab, (B, N_NEW)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((B, N_PATCH, cfg.d_model)).astype(np.float32)
    return out


def train_batches(seed=7):
    """recurrentgemma-2b's STEPS batches of ROWS x SEQ tokens (a row half masked)."""
    cfg = smoke_config("recurrentgemma-2b")
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(seed + i)
        toks = rng.integers(0, cfg.vocab, (ROWS, SEQ + 1))
        mask = np.ones((ROWS, SEQ), np.float32)
        mask[-1, SEQ // 2:] = 0.0
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32), "loss_mask": mask})
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


COMMON = r"""
import json, os, sys, time
import numpy as np

io = sys.argv[-1]
B, P, CACHE_LEN, N_NEW, N_PATCH = 2, 8, 20, 4, 4
STEPS, LR = 3, 1e-2
inputs = dict(np.load(f"{io}/inputs.npz"))
with open(f"{io}/jobs.json") as f:
    JOBS = json.load(f)


def tree_of(prefix, wrap=lambda v: v):
    tree = {}
    for k, v in inputs.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        *head, last = k[len(prefix) + 1:].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = wrap(v)
    return tree


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out
"""

RANK_SIDE = COMMON + r"""
import datetime
import torch
import torch.distributed as dist
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
rank = int(sys.argv[1])
from repro_torch.api.serving import ServeSession
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.optim.optimizers import tree_map
from repro_torch.roofline.collectives import recording
from repro_torch.train.steps import (build_sharding_plan, make_prefill_step, make_serve_step,
                                     make_spmd_train_step, mesh_rank)


def cache_piece(model, full, mesh, r):
    # this rank's piece of a whole cache tree, laid out as init_cache lays it
    axes = model.cache_logical_axes()

    def cut(t, ax):
        lay = SH.layout_for(SH._divisible_spec(SH.spec_for(ax, SH.get_rules()),
                                               tuple(t.shape), mesh), mesh)
        return lay.local(t, r).clone()

    def walk(tree, ax):
        return {k: walk(v, ax[k]) if isinstance(v, dict) else cut(v, ax[k])
                for k, v in tree.items()}

    return walk(full, axes)


def setup(job):
    arch, kv = job["arch"], job["kv"]
    m = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
    mesh = make_host_mesh(data=job["data"], model=job["model"])
    plan = build_sharding_plan(m, adamw(), mesh=mesh, global_rows=B, seq_len=P)
    r = mesh_rank(mesh)
    params = tree_map(lambda t, lay: lay.local(t, r).clone(),
                      params_from_jax(tree_of(arch), "cpu"), plan.params)
    per = B // job["data"]
    rows = slice(mesh.get_coordinate()[0] * per, (mesh.get_coordinate()[0] + 1) * per)
    side = {k: torch.from_numpy(inputs[f"serve{arch}/{k}"][rows])
            for k in ("frames", "patch_embeds") if f"serve{arch}/{k}" in inputs}
    return m, mesh, plan, r, params, rows, side


def serve(job):
    m, mesh, plan, r, params, rows, side = setup(job)
    arch = job["arch"]
    prompt = torch.from_numpy(inputs[f"serve{arch}/prompt"][rows]).long()
    forced = torch.from_numpy(inputs[f"serve{arch}/forced"][rows]).long()
    n_pre = P + (N_PATCH if "patch_embeds" in side else 0)
    arrays, out = {}, {"ops": {}}
    with SH.use_rules(plan.rules), SH.use_mesh(mesh):
        zero = m.init_cache(B, CACHE_LEN, device="cpu")
        out["init_shapes"] = {k: list(v.shape) for k, v in flat(zero).items()}
        log = []
        with recording(log):
            logits, cache = m.prefill(params, prompt, CACHE_LEN, **side)
        out["ops"]["prefill"] = log
        out["cache_shapes"] = {k: list(v.shape) for k, v in flat(cache).items()}
        arrays["prefill"] = logits
        arrays.update({f"cache/{k}": v.clone() for k, v in flat(cache).items()})
        out["ops"]["decode"] = []
        for t in range(N_NEW):
            pos = torch.full((prompt.shape[0],), n_pre + t, dtype=torch.int32)
            log = []
            with recording(log):
                logits, cache = m.decode_step(params, forced[:, t:t + 1], cache, pos)
            out["ops"]["decode"].append(log)
            arrays[f"decode{t}"] = logits
        log = []
        with recording(log):
            got = ServeSession(model=m, params=params, device="cpu").generate(
                prompt, max_new_tokens=N_NEW, cache_len=CACHE_LEN, **side)
        out["ops"]["generate"] = log
        arrays["generate"] = got.tokens
        if arch in ("rwkv6-7b", "recurrentgemma-2b"):
            logits, cache = make_prefill_step(m, CACHE_LEN)(params, prompt)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            step, toks = make_serve_step(m), [tok]
            for t in range(N_NEW):
                pos = torch.full((prompt.shape[0],), P + t, dtype=torch.int32)
                tok, _, cache = step(params, tok, cache, pos)
                toks.append(tok)
            arrays["batched"] = torch.cat(toks, dim=1)
    return out, arrays


def decode_on_reference(job):
    # the int8 decode steps on this rank's piece of the reference's cache
    m, mesh, plan, r, params, rows, side = setup(job)
    arch, kv = job["arch"], job["kv"]
    deadline = time.time() + 240
    while not os.path.exists(f"{io}/reference.done"):
        if time.time() > deadline:
            raise TimeoutError("no reference cache")
        time.sleep(0.2)
    ref = dict(np.load(f"{io}/reference.npz"))
    pre = f"{arch}/{kv}/cache/"
    full = {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items() if k.startswith(pre)}
    forced = torch.from_numpy(inputs[f"serve{arch}/forced"][rows]).long()
    arrays = {}
    with SH.use_rules(plan.rules), SH.use_mesh(mesh):
        cache = cache_piece(m, full, mesh, r)
        for t in range(N_NEW):
            pos = torch.full((forced.shape[0],), P + t, dtype=torch.int32)
            logits, cache = m.decode_step(params, forced[:, t:t + 1], cache, pos)
            arrays[f"decode{t}"] = logits
    return {}, arrays


def train(job):
    cfg = smoke_config(job["arch"])
    m = get_model(cfg)
    mesh = make_host_mesh(data=job["data"], model=job["model"])
    plan = SH.check_plan(build_sharding_plan(m, adamw(), mesh=mesh, global_rows=4, seq_len=16),
                         job["data"] * job["model"])
    r = mesh_rank(mesh)
    params = tree_map(lambda t, lay: lay.local(t, r).clone(),
                      params_from_jax(tree_of(job["arch"]), "cpu"), plan.params)
    opt = sgd_momentum()
    log = []
    step = make_spmd_train_step(m, opt, lambda s: torch.tensor(LR), timing={}, plan=plan,
                                collective_log=log)
    state = opt.init(params)
    out = {"losses": [], "grad_norms": []}
    for i in range(STEPS):
        b = {k: torch.from_numpy(inputs[f"train/{i}/{k}"]) for k in ("tokens", "labels",
                                                                    "loss_mask")}
        params, state, met = step(params, state, b)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
    out["ops"] = log
    out["wq"] = params["groups"]["A"]["attn"]["wq"].numpy().tolist()
    return out, {}


def run(world):
    dist.init_process_group("gloo", init_method=f"file://{io}/store-{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    out, arrays = {}, {}
    for job in JOBS[str(world)]:
        rec, arr = {"serve": serve, "train": train, "int8": decode_on_reference}[job["kind"]](job)
        out[job["name"]] = rec
        arrays.update({f"{job['name']}/{k}": v.detach().numpy() for k, v in arr.items()})
    with open(f"{io}/world{world}.{rank}.json", "w") as f:
        json.dump(out, f)
    np.savez(f"{io}/world{world}.{rank}.npz", **arrays)
    dist.barrier()
    dist.destroy_process_group()


if rank < 2 and JOBS.get("2"):
    run(2)
if JOBS.get("4"):
    run(4)
"""

JAX_SIDE = COMMON + r"""
import jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import smoke_config
from repro.distributed.sharding import arg_shardings_for_tree, make_rules
from repro.models.api import get_model
from repro.optim import sgd_momentum
from repro.train import steps as JS

arrays, out = {}, {}
for arch, kv in JOBS["reference"]:
    jm = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
    params = tree_of(arch, jnp.asarray)
    side = {k: jnp.asarray(inputs[f"serve{arch}/{k}"]) for k in ("frames", "patch_embeds")
            if f"serve{arch}/{k}" in inputs}
    prompt = jnp.asarray(inputs[f"serve{arch}/prompt"])
    forced = jnp.asarray(inputs[f"serve{arch}/forced"])
    n_pre = P + (N_PATCH if "patch_embeds" in side else 0)
    jprefill = jax.jit(lambda p, t, s: jm.prefill(p, t, CACHE_LEN, **s))
    jdecode = jax.jit(jm.decode_step)
    name = f"{arch}/{kv}"
    logits, cache = jprefill(params, prompt, side)
    arrays[f"{name}/prefill"] = np.asarray(logits)
    arrays.update({f"{name}/cache/{k}": np.asarray(v) for k, v in flat(cache).items()})
    c = cache
    for t in range(N_NEW):
        lg, c = jdecode(params, forced[:, t:t + 1], c, jnp.full((B,), n_pre + t, jnp.int32))
        arrays[f"{name}/decode{t}"] = np.asarray(lg)

    def greedy(logits, c, start):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks = [tok]
        for t in range(N_NEW):
            lg, c = jdecode(params, tok, c, jnp.full((B,), start + t, jnp.int32))
            tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
            toks.append(tok)
        return np.asarray(jnp.concatenate(toks, axis=1))

    arrays[f"{name}/batched"] = greedy(logits, cache, n_pre)
    if arch in ("rwkv6-7b", "recurrentgemma-2b"):
        # the reference ServeSession's stepped prefill: the prompt a token at a time
        c = jm.init_cache(B, CACHE_LEN)
        for t in range(P):
            lg, c = jdecode(params, prompt[:, t:t + 1], c, jnp.full((B,), t, jnp.int32))
        arrays[f"{name}/stepped"] = greedy(lg, c, P)
    shapes = {}
    axes = jm.cache_logical_axes()
    abstract = jm.abstract_cache(B, CACHE_LEN)
    for shape in ((1, 2), (2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"))
        sh = arg_shardings_for_tree(axes, abstract, make_rules(), mesh)
        leaves = flat(jax.tree_util.tree_map(lambda s, a: list(s.shard_shape(a.shape)), sh,
                                             abstract))
        shapes[f"{shape[0]}x{shape[1]}"] = leaves
    out[name] = shapes
np.savez(f"{io}/reference.npz", **arrays)
open(f"{io}/reference.done", "w").close()

m = get_model(smoke_config("recurrentgemma-2b"))
opt = sgd_momentum()
step = jax.jit(JS.make_train_step(m, opt, lambda s: jnp.float32(LR)))
p = tree_of("recurrentgemma-2b", jnp.asarray)
s = opt.init(p)
losses, norms = [], []
for i in range(STEPS):
    b = {k: jnp.asarray(inputs[f"train/{i}/{k}"]) for k in ("tokens", "labels", "loss_mask")}
    p, s, met = step(p, s, b)
    losses.append(float(met["loss"]))
    norms.append(float(met["grad_norm"]))
out["train"] = {"losses": losses, "grad_norms": norms,
                "wq": np.asarray(p["groups"]["A"]["attn"]["wq"]).tolist()}
with open(f"{io}/reference.json", "w") as f:
    json.dump(out, f)
"""


def jobs():
    """The ranks' runs a world size, and the reference's configs."""
    out = {"2": [], "4": [], "reference": CONFIGS}
    for arch, kv, mesh in CASES:
        job = {"kind": "serve", "name": key(arch, kv, mesh), "arch": arch, "kv": kv,
               "data": mesh[0], "model": mesh[1]}
        out[str(mesh[0] * mesh[1])].append(job)
    out["4"].append({"kind": "train", "name": "train", "arch": "recurrentgemma-2b", "data": 1,
                     "model": 4})
    for arch, kv, mesh in CASES:
        if kv == "int8":
            out[str(mesh[0] * mesh[1])].append(
                {"kind": "int8", "name": key(arch, kv, mesh) + "/on-reference", "arch": arch,
                 "kv": kv, "data": mesh[0], "model": mesh[1]})
    return out


def _spawn(code, args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> ({world: [per-rank (record, arrays)]}, the reference's (record, arrays))."""
    io = str(tmp_path_factory.mktemp("tps"))
    flat = {}
    for arch in ARCHS:
        flat.update({f"{arch}/{k}": v for k, v in _flat(numpy_params(arch)).items()})
        flat.update({f"serve{arch}/{k}": v for k, v in serve_inputs(arch).items()})
    for i, b in enumerate(train_batches()):
        flat.update({f"train/{i}/{k}": v for k, v in b.items()})
    np.savez(os.path.join(io, "inputs.npz"), **flat)
    with open(os.path.join(io, "jobs.json"), "w") as f:
        json.dump(jobs(), f)
    # the reference's sixteen serving compiles and its training step are most of
    # its process's time; LLVM's optimization passes buy nothing at these sizes
    # (its outputs stay within 1e-6 of the default level's, its int8 bytes and
    # tokens equal)
    procs = [_spawn(JAX_SIDE, [io], {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": (
        "--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true")})]
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
    for world in (2, 4):
        out[world] = []
        for r in range(world):
            with open(os.path.join(io, f"world{world}.{r}.json")) as f:
                rec = json.load(f)
            out[world].append((rec, dict(np.load(os.path.join(io, f"world{world}.{r}.npz")))))
    with open(os.path.join(io, "reference.json")) as f:
        ref = json.load(f)
    return out, (ref, dict(np.load(os.path.join(io, "reference.npz"))))


def _ranks(runs, case):
    """[(rank, its data rows, its record, its arrays)] of a serving case."""
    arch, kv, (data, model_ways) = case
    name = key(*case)
    per = B // data
    return [(r, slice((r // model_ways) * per, (r // model_ways + 1) * per), rec[name],
             {k[len(name) + 1:]: v for k, v in arr.items() if k.startswith(name + "/")})
            for r, (rec, arr) in enumerate(runs[0][data * model_ways])]


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _plan(arch, kv, mesh):
    model = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
    return model, build_sharding_plan(model, adamw(), mesh=SH.ProcessMesh(torch.device("cpu"),
                                                                          mesh),
                                      global_rows=B, seq_len=P)


def _reference_piece(model, plan, name, full, r):
    """The piece of the reference's whole cache leaf ``name`` that flat rank
    ``r`` holds under ``plan``'s rules."""
    axes = model.cache_logical_axes()
    for part in name.split("/"):
        axes = axes[part]
    mesh = plan.mesh
    lay = SH.layout_for(SH._divisible_spec(SH.spec_for(axes, plan.rules), full.shape, mesh),
                        mesh)
    return lay.local(torch.from_numpy(full), r).numpy()


# ---------------------------------------------------------------------------
# prefill, decode and generate against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=lambda c: key(*c))
def test_tp_prefill_and_decode_equal_the_reference(runs, case):
    """Every rank's whole prefill logits of its rows and its four
    teacher-forced decode steps' equal the reference's one device (an int8
    cache's steps on the rank's piece of the reference's prefill bytes);
    the ranks of a data group hold the same bytes."""
    arch, kv, _ = case
    ref = runs[1][1]
    name = f"{arch}/{kv}"
    ranks = _ranks(runs, case)
    for r, rows, rec, arr in ranks:
        _close(arr["prefill"], ref[f"{name}/prefill"][rows])
        at = "on-reference/" if kv == "int8" else ""
        for t in range(N_NEW):
            _close(arr[f"{at}decode{t}"], ref[f"{name}/decode{t}"][rows])
    for r, rows, rec, arr in ranks[1:]:
        group = ranks[(r // case[2][1]) * case[2][1]][3]
        assert np.array_equal(arr["prefill"], group["prefill"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: key(*c))
def test_tp_cache_is_the_reference_shard(runs, case):
    """Every cache leaf a rank holds has the reference's shard shape
    (``NamedSharding.shard_shape`` of its ``arg_shardings_for_tree`` on
    fake devices), whether ``init_cache`` allocated it or prefill wrote it,
    and holds the reference's prefill cache at the rank's piece: float
    leaves to the logits' tolerance, int8 bytes within 1 LSB (at most 1%
    of them differing), scales at rtol 1e-5."""
    arch, kv, mesh = case
    ref_rec, ref = runs[1]
    want_shapes = ref_rec[f"{arch}/{kv}"][f"{mesh[0]}x{mesh[1]}"]
    model, plan = _plan(arch, kv, mesh)
    for r, rows, rec, arr in _ranks(runs, case):
        assert rec["init_shapes"] == want_shapes
        assert rec["cache_shapes"] == want_shapes
        for leaf in want_shapes:
            got = arr[f"cache/{leaf}"]
            full = ref[f"{arch}/{kv}/cache/{leaf}"]
            want = _reference_piece(model, plan, leaf, full, r)
            if got.dtype == np.int8:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, leaf
            elif leaf.endswith("_scale"):
                np.testing.assert_allclose(got, want, rtol=1e-5)
            else:
                _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: key(*c))
def test_tp_generate_equals_the_reference_greedy_stream(runs, case):
    """``ServeSession.generate`` on every rank gives its rows' greedy tokens
    of the reference (for the recurrent pair, the reference's stepped
    prefill, as its ServeSession's), and the batched route
    (``make_prefill_step`` + ``make_serve_step``) the reference's batched
    stream."""
    arch, kv, _ = case
    ref = runs[1][1]
    want = ref[f"{arch}/{kv}/stepped" if arch in RECURRENT else f"{arch}/{kv}/batched"]
    for r, rows, rec, arr in _ranks(runs, case):
        np.testing.assert_array_equal(arr["generate"], want[rows])
        if arch in RECURRENT:
            np.testing.assert_array_equal(arr["batched"], ref[f"{arch}/{kv}/batched"][rows])


@pytest.mark.parametrize("case", CASES, ids=lambda c: key(*c))
def test_tp_serving_moves_the_closed_form_collectives(runs, case):
    """A prefill's, each decode step's and generate's collectives equal
    ``roofline.collectives.tp_serve_ops`` op for op (generate's recurrent
    prefill is stepped: P more decode steps)."""
    arch, kv, mesh = case
    cfg = smoke_config(arch).with_(kv_cache_dtype=kv)
    _, plan = _plan(arch, kv, mesh)
    rows = B // mesh[0]
    patches = N_PATCH if cfg.family == "vlm" else 0
    step = sorted(tp_serve_ops(cfg, plan, rows, 0, 1))
    prefill = sorted(tp_serve_ops(cfg, plan, rows, P, 0, patches=patches))
    gen = sorted(tp_serve_ops(cfg, plan, rows, 0, P + N_NEW) if arch in RECURRENT
                 else tp_serve_ops(cfg, plan, rows, P, N_NEW, patches=patches))
    assert step and prefill
    for r, _, rec, _ in _ranks(runs, case):
        assert sorted(map(tuple, rec["ops"]["prefill"])) == prefill
        for log in rec["ops"]["decode"]:
            assert sorted(map(tuple, log)) == step
        assert sorted(map(tuple, rec["ops"]["generate"])) == gen


# ---------------------------------------------------------------------------
# indivisible query heads
# ---------------------------------------------------------------------------


def test_indivisible_heads_train_as_the_reference(runs):
    """recurrentgemma-2b's 2 query heads over ``model`` = 4 (a padded split:
    1, 1, 0, 0 heads a rank): three SGD-momentum steps of every rank equal
    the reference's single-device ``jit(make_train_step)``, the ranks agree,
    the whole ``wq`` after them is the reference's on every rank (its
    gradient summed over ``model``), and the step's collectives are
    ``tp_step_ops``'s, the weights' gradient sums included."""
    from repro_torch.roofline.collectives import tp_step_ops

    want = runs[1][0]["train"]
    cfg = smoke_config("recurrentgemma-2b")
    ranks = [rec["train"] for rec, _ in runs[0][4]]
    ops = sorted(tp_step_ops(cfg, ROWS, SEQ, 4))
    for out in ranks:
        np.testing.assert_allclose(out["losses"][0], want["losses"][0], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"][0], want["grad_norms"][0], rtol=1e-5)
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=3e-3)
        np.testing.assert_allclose(out["grad_norms"], want["grad_norms"], rtol=3e-3)
        np.testing.assert_allclose(out["wq"], want["wq"], atol=1e-4)
        assert out["losses"] == ranks[0]["losses"] and out["wq"] == ranks[0]["wq"]
        assert sorted(map(tuple, out["ops"])) == ops


@pytest.mark.parametrize("heads,ways,blocks", [
    (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),
    (10, 4, [(0, 3), (3, 6), (6, 9), (9, 10)]),
    (10, 2, [(0, 5), (5, 10)]),
    (4, 8, [(0, 1), (1, 2), (2, 3), (3, 4)] + [(4, 4)] * 4),
])
def test_head_blocks_are_the_padded_split(heads, ways, blocks):
    """A rank's block of query heads is ``ceil(H / m)`` heads in rank order,
    the last ranks fewer or none (recurrentgemma-2b: 2 heads at 4 ranks give
    1, 1, 0, 0; the published 10 give 3, 3, 3, 1)."""
    got = []
    for i in range(ways):
        axis = tensor.ModelAxis(group=None, size=ways, index=i, data_group=None, data_size=1,
                                batch_over_model=False)
        plan = tensor.TensorPlan(axis=axis, heads=True, kv_heads=False, mlp=True, vocab=True,
                                 experts=False, n_heads=heads, n_kv_heads=1,
                                 pad_heads=heads % ways != 0)
        got.append(plan.head_block)
    assert got == blocks


def test_init_cache_outside_a_mesh_is_whole():
    """Outside a mesh (or on a mesh of one device) ``init_cache`` is the
    whole cache, and ``cache_logical_axes`` names one axis a dim of every
    leaf, for every family."""
    for arch in ARCHS:
        model = get_model(smoke_config(arch))
        cache = model.init_cache(B, CACHE_LEN, device="cpu")
        axes = _flat(model.cache_logical_axes())
        for name, leaf in _flat(cache).items():
            if leaf.numel():
                assert len(axes[name]) == leaf.dim(), (arch, name)
        with SH.use_mesh(SH.ProcessMesh(torch.device("cpu"))):
            again = model.init_cache(B, CACHE_LEN, device="cpu")
        assert {k: v.shape for k, v in _flat(again).items()} == \
            {k: v.shape for k, v in _flat(cache).items()}
