"""Tensor parallelism over the ``model`` axis on the CPU for the recurrent,
encoder-decoder and vision-language families: the smoke rwkv6-7b,
recurrentgemma-2b, whisper-medium (with ``frames``) and qwen2-vl-7b (with
``patch_embeds``) train on a ``(data, model)`` ``DeviceMesh`` of ``gloo``
ranks through ``build_sharding_plan`` + ``make_spmd_train_step(plan=)``,
against the reference's single-device ``jit(make_train_step)``.

One module fixture launches every run at once, each rendezvous a file store
under the test's temporary directory:

* four ranks; first two of them as a world-2 group at mesh (1 x 2): the
  four families in ``f32`` and the recurrent pair in ``int8-fused``, and
  the int8 RG-LRU scan on a rank's channels; then all four at (2 x 2) (the
  four families, and rwkv6-7b under ``fsdp=True``, ZeRO-3 over ``data``
  composed with the ``model`` pieces, then one AdamW step saved as a
  chunked checkpoint) and (1 x 4) (all but recurrentgemma-2b, whose 2
  query heads the axis does not divide);
* the reference: ``jit(make_train_step)`` of each family on one device, in
  ``f32`` and, for the recurrent pair, ``int8-fused``, from the same numpy
  weight tree and batches, SGD-momentum, 3 steps.

Tolerances: loss and gradient norm at rtol 1e-5; the recurrent pair's steps
after the first at 3e-3 (a tiny difference in the summation order of the
ranks' partial sums grows through their recurrences over the steps,
ROADMAP's "chaotic smoke models"); ``int8-fused`` at 1e-2 (a partial sum
one rounding away from the single program's can move an int8 level).
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

from repro.checkpoint import manager as JM
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import get_model as jax_get_model
from repro.optim.optimizers import OptState as JOptState
from repro_torch.checkpoint import restore
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ref as R
from repro_torch.models import rglru
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.roofline.collectives import collective_bytes, tp_step_ops
from repro_torch.train.steps import build_sharding_plan, make_train_step

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "whisper-medium", "qwen2-vl-7b")
RECURRENT = ("rwkv6-7b", "recurrentgemma-2b")
MESHES = {arch: ((1, 2), (2, 2), (1, 4)) for arch in ARCHS}
MESHES["recurrentgemma-2b"] = ((1, 2), (2, 2))
CASES = [(arch, "f32", mesh) for arch in ARCHS for mesh in MESHES[arch]] + \
    [(arch, "int8-fused", (1, 2)) for arch in RECURRENT]
STEPS, LR, ROWS, SEQ, N_PATCH = 3, 1e-2, 4, 16, 4


def numpy_params(arch, seed=0):
    """A float32 parameter tree of ``arch``'s smoke config with the leaves of
    the reference's abstract init, drawn with numpy: norm scales 1, biases
    and shifts N(0, 0.1^2), embedding tables N(0, 1), RG-LRU's ``lam``
    U(2.2, 6.9) (its init: a in [0.9, 0.999]), every other leaf
    N(0, 1/fan_in) over the axis it contracts (the second of the stacked
    leaf)."""
    abstract, _ = jax_get_model(jax_smoke_config(arch)).init_params(abstract=True)
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "scale":
            return np.ones(shape)
        if name in ("bias", "b", "bq", "bk", "bv", "bi", "bo", "dec_pos"):
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


def batches(arch, seed=7):
    """STEPS batches of ROWS x SEQ tokens (one row half masked), with
    whisper's frames or qwen2-vl's N_PATCH patch embeddings (labels over
    the text)."""
    cfg = smoke_config(arch)
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(seed + i)
        toks = rng.integers(0, cfg.vocab, (ROWS, SEQ + 1))
        mask = np.ones((ROWS, SEQ), np.float32)
        mask[-1, SEQ // 2:] = 0.0
        b = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32),
             "loss_mask": mask}
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal((ROWS, cfg.n_frames, cfg.d_model)).astype(
                np.float32)
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.standard_normal((ROWS, N_PATCH, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


def scan_inputs(seed=5):
    """The RG-LRU scan's input (B, S, W) at the smoke width, with every row's
    absmax in the second half of its channels (so a rank of the first half
    holds a smaller absmax than its row's), and the gates."""
    W = smoke_config("recurrentgemma-2b").lru_width
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, W))
    x[..., W // 2:] *= 4.0
    return {"x": x, "wa": rng.standard_normal(W) / 4, "ba": rng.standard_normal(W) / 4,
            "wx": rng.standard_normal(W) / 4, "bx": rng.standard_normal(W) / 4,
            "lam": rng.uniform(2.2, 6.9, W)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def key(arch, prec, mesh, tag=""):
    return f"{arch}/{prec}/{mesh[0]}x{mesh[1]}{tag}"


RANK_SIDE = r"""
import datetime, hashlib, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
rank, io = int(sys.argv[1]), sys.argv[2]
from repro_torch.checkpoint.manager import finalize_process_save, save_process
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import rglru
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.optim.optimizers import tree_map
from repro_torch.train.steps import (build_sharding_plan, make_spmd_train_step, mesh_rank,
                                     tree_leaves_sorted, _sorted_paths)

STEPS, LR, ROWS, SEQ = 3, 1e-2, 4, 16
inputs = dict(np.load(f"{io}/inputs.npz"))
with open(f"{io}/jobs.json") as f:
    JOBS = json.load(f)


def tree_of(prefix):
    flat = {k[len(prefix) + 1:]: v for k, v in inputs.items() if k.startswith(prefix + "/")}
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_items(v, path)
        else:
            yield path, v


def train(arch, prec, data, model_ways, fsdp=False, ckpt=None, rules=None):
    cfg = smoke_config(arch).with_(fsdp=fsdp, train_precision=prec)
    m = get_model(cfg)
    mesh = make_host_mesh(data=data, model=model_ways)
    plan = SH.check_plan(build_sharding_plan(m, adamw(), mesh=mesh, global_rows=ROWS,
                                             seq_len=SEQ, extra_rules=rules), data * model_ways)
    r = mesh_rank(mesh)
    whole = params_from_jax(tree_of(arch), "cpu")
    params = tree_map(lambda t, lay: lay.local(t, r).clone(), whole, plan.params)
    opt = sgd_momentum()
    log = []
    step = make_spmd_train_step(m, opt, lambda s: torch.tensor(LR), timing={}, plan=plan,
                                collective_log=log)
    state = opt.init(params)
    g, per = mesh.get_coordinate()[0], ROWS // data
    out = {"losses": [], "grad_norms": []}
    for i in range(STEPS):
        b = {k[len(f"batch{arch}/{i}/"):]: torch.from_numpy(v) for k, v in inputs.items()
             if k.startswith(f"batch{arch}/{i}/")}
        mine = {k: v[g * per:(g + 1) * per] for k, v in b.items()}
        params, state, met = step(params, state, mine)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
    out["ops"] = [list(op) for op in log]
    lays = tree_leaves_sorted(plan.params)
    out["replicated_digest"] = digest([t for t, lay in zip(tree_leaves_sorted(params), lays)
                                       if lay.model_dim is None])
    out["shapes"] = {"/".join(p): list(t.shape) for p, t in
                     zip(_sorted_paths(params), tree_leaves_sorted(params))}
    if ckpt:
        opt = adamw()
        state = opt.init(params)
        step = make_spmd_train_step(m, opt, lambda s: torch.tensor(1e-3), timing={}, plan=plan)
        params, state, _ = step(params, state, mine)
        tree = {"params": params, "opt": state}
        lay = {"params": plan.params, "opt": plan.opt}
        save_process(f"{io}/{ckpt}", 1, tree, process_index=rank,
                     num_processes=dist.get_world_size(), layouts=lay, coord=r,
                     metadata={"step": 1})
        dist.barrier()
        if rank == 0:
            finalize_process_save(f"{io}/{ckpt}", 1, num_processes=dist.get_world_size())
        pieces = {"params/" + p: t for p, t in _flat_items(params)}
        pieces.update({"mu/" + p: t for p, t in _flat_items(state.mu)})
        pieces.update({"nu/" + p: t for p, t in _flat_items(state.nu)})
        np.savez(f"{io}/pieces.{rank}.npz", **{k: v.numpy() for k, v in pieces.items()})
    return out


def row_scale(model_ways):
    # the int8 RG-LRU scan on this rank's channels of scan/x, and the same
    # channels quantized against their own row absmax (what a rank would get
    # without the whole row's scale)
    cfg = smoke_config("recurrentgemma-2b").with_(train_precision="int8-fused")
    mesh = make_host_mesh(data=1, model=model_ways)
    j = int(mesh.get_coordinate()[1])
    n = cfg.lru_width // model_ways
    cut = lambda t: torch.from_numpy(t[..., j * n:(j + 1) * n].astype(np.float32))
    p = {k: cut(inputs["scan/" + k]) for k in ("wa", "ba", "wx", "bx", "lam")}
    x = cut(inputs["scan/x"])
    with SH.use_mesh(mesh):
        tp = tensor.plan_for(cfg)
        y = rglru.rglru_scan(p, x, "int8-fused", tp)
    own = rglru.rglru_scan(p, x, "int8-fused")
    return {"cols": [j * n, (j + 1) * n], "y": y.tolist(), "own_scale": own.tolist()}


def run(world):
    dist.init_process_group("gloo", init_method=f"file://{io}/store-{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    out = {}
    for job in JOBS[str(world)]:
        if job["kind"] == "row_scale":
            out[job["name"]] = row_scale(job["model"])
        else:
            out[job["name"]] = train(job["arch"], job["prec"], job["data"], job["model"],
                                     job.get("fsdp", False), job.get("ckpt"), job.get("rules"))
    with open(f"{io}/world{world}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if rank < 2 and JOBS.get("2"):
    run(2)
if JOBS.get("4"):
    run(4)
"""

JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.models.api import get_model
from repro.optim import sgd_momentum
from repro.train import steps as JS

io = sys.argv[1]
STEPS, LR = 3, 1e-2
inputs = dict(np.load(io + "/inputs.npz"))
with open(io + "/jobs.json") as f:
    want = json.load(f)["reference"]


def tree_of(prefix):
    tree = {}
    for k, v in inputs.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        *head, last = k[len(prefix) + 1:].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


out = {}
for arch, prec in want:
    m = get_model(smoke_config(arch).with_(train_precision=prec))
    opt = sgd_momentum()
    step = jax.jit(JS.make_train_step(m, opt, lambda s: jnp.float32(LR)))
    p = tree_of(arch)
    s = opt.init(p)
    losses, norms = [], []
    for i in range(STEPS):
        pre = f"batch{arch}/{i}/"
        b = {k[len(pre):]: jnp.asarray(v) for k, v in inputs.items() if k.startswith(pre)}
        p, s, met = step(p, s, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    out[f"{arch}/{prec}"] = {"losses": losses, "grad_norms": norms}
with open(io + "/reference.json", "w") as f:
    json.dump(out, f)
"""


def jobs():
    """The ranks' runs a world size, and the reference's (arch, precision) pairs."""
    out = {"2": [], "4": [], "reference": sorted({(a, p) for a, p, _ in CASES})}
    for arch, prec, mesh in CASES:
        job = {"kind": "train", "name": key(arch, prec, mesh), "arch": arch, "prec": prec,
               "data": mesh[0], "model": mesh[1]}
        out[str(mesh[0] * mesh[1])].append(job)
    out["2"].append({"kind": "row_scale", "name": "row_scale", "model": 2})
    out["2"].append({"kind": "train", "name": key("rwkv6-7b", "f32", (1, 2), "-lru-whole"),
                     "arch": "rwkv6-7b", "prec": "f32", "data": 1, "model": 2,
                     "rules": {"lru": None}})
    out["4"].append({"kind": "train", "name": key("rwkv6-7b", "f32", (2, 2), "-fsdp"),
                     "arch": "rwkv6-7b", "prec": "f32", "data": 2, "model": 2, "fsdp": True,
                     "ckpt": "ckpt"})
    return out


def _spawn(code, args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (io dir, {world: [per-rank outputs]}, the reference's outputs)."""
    io = str(tmp_path_factory.mktemp("tpf"))
    flat = {}
    for arch in ARCHS:
        flat.update({f"{arch}/{k}": v for k, v in _flat(numpy_params(arch)).items()})
        for i, b in enumerate(batches(arch)):
            flat.update({f"batch{arch}/{i}/{k}": v for k, v in b.items()})
    flat.update({f"scan/{k}": v.astype(np.float32) for k, v in scan_inputs().items()})
    np.savez(os.path.join(io, "inputs.npz"), **flat)
    with open(os.path.join(io, "jobs.json"), "w") as f:
        json.dump(jobs(), f)
    procs = [_spawn(JAX_SIDE, [io], {"JAX_PLATFORMS": "cpu"})]
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
                out[world].append(json.load(f))
    with open(os.path.join(io, "reference.json")) as f:
        ref = json.load(f)
    return io, out, ref


def _ranks(runs, name, world):
    return [out[name] for out in runs[1][world]]


# ---------------------------------------------------------------------------
# training against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES + [("rwkv6-7b", "f32", (1, 2), "-lru-whole")],
                         ids=lambda c: key(*c))
def test_tp_training_equals_the_reference_train_step(runs, case):
    """Three SGD-momentum steps at the case's mesh: every rank's loss and
    gradient norm equal the reference's single-device ``jit(make_train_step)``
    (the tolerances of the module doc), the ranks agree, and the leaves
    replicated over ``model`` are bit for bit the same on every rank.  The
    ``lru-whole`` case keeps RWKV-6's ``lru`` axis whole by its rules
    (``{"lru": None}``): time mixing runs whole on every rank, channel mixing
    splits its FFN columns after its whole mix vectors."""
    arch, prec, mesh = case[:3]
    want = runs[2][f"{arch}/{prec}"]
    ranks = _ranks(runs, key(*case), mesh[0] * mesh[1])
    for out in ranks:
        if prec == "int8-fused":
            np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-2)
            np.testing.assert_allclose(out["grad_norms"], want["grad_norms"], rtol=1e-2)
        else:
            later = 3e-3 if arch in RECURRENT else 1e-5
            np.testing.assert_allclose(out["losses"][0], want["losses"][0], rtol=1e-5)
            np.testing.assert_allclose(out["grad_norms"][0], want["grad_norms"][0], rtol=1e-5)
            np.testing.assert_allclose(out["losses"][1:], want["losses"][1:], rtol=later)
            np.testing.assert_allclose(out["grad_norms"][1:], want["grad_norms"][1:],
                                       rtol=later)
        assert out["losses"] == ranks[0]["losses"]
    assert len({out["replicated_digest"] for out in ranks}) == 1


@pytest.mark.parametrize("arch", ("rwkv6-7b", "whisper-medium", "qwen2-vl-7b"))
def test_a_rank_holds_its_pieces(runs, arch):
    """At (1 x 4) a rank holds a quarter of the ``lru`` channels (rwkv6-7b:
    one head of 16 of the 4), of the query heads and KV heads, of the FFN
    columns and of the vocabulary; norms and rwkv6's decay LoRA ``wa`` stay
    whole."""
    cfg = smoke_config(arch)
    shapes = _ranks(runs, key(arch, "f32", (1, 4)), 4)[0]["shapes"]
    d = cfg.d_model
    if arch == "rwkv6-7b":
        L = cfg.n_layers
        assert shapes["blocks/tmix/wr"] == [L, d, d // 4]
        assert shapes["blocks/tmix/wo"] == [L, d // 4, d]
        assert shapes["blocks/tmix/mu_w"] == [L, d // 4]
        assert shapes["blocks/tmix/wa"] == [L, d, cfg.decay_lora]
        assert shapes["blocks/cmix/wk"] == [L, d, cfg.d_ff // 4]
        assert shapes["blocks/ln1/scale"] == [L, d]
    else:
        blocks = "dec_blocks/cross_attn" if arch == "whisper-medium" else "blocks/attn"
        L = cfg.n_dec_layers if arch == "whisper-medium" else cfg.n_layers
        kv = cfg.n_kv_heads // 4 if cfg.n_kv_heads % 4 == 0 else cfg.n_kv_heads
        assert shapes[f"{blocks}/wq"] == [L, d, cfg.n_heads // 4, cfg.resolved_head_dim()]
        assert shapes[f"{blocks}/wk"] == [L, d, kv, cfg.resolved_head_dim()]
    assert shapes["embedding/table"] == [cfg.vocab // 4, d]


def test_recurrentgemma_rank_pieces(runs):
    """At (1 x 2) a recurrentgemma-2b rank holds half of the RG-LRU width in
    ``in_rec`` / ``in_gate`` (columns), the conv, the gates and ``lam``, and
    in ``out`` (rows); one of the 2 query heads over the one KV head, whole."""
    cfg = smoke_config("recurrentgemma-2b")
    shapes = _ranks(runs, key("recurrentgemma-2b", "f32", (1, 2)), 2)[0]["shapes"]
    W, d = cfg.lru_width, cfg.d_model
    n_r = rglru.layer_kinds(cfg).count("R")
    assert shapes["groups/R/in_rec/w"] == [n_r, d, W // 2]
    assert shapes["groups/R/conv/w"] == [n_r, cfg.conv_width, W // 2]
    assert shapes["groups/R/lru/lam"] == [n_r, W // 2]
    assert shapes["groups/R/out/w"] == [n_r, W // 2, d]
    assert shapes["groups/A/attn/wq"][2] == 1
    assert shapes["groups/A/attn/wk"][2] == 1


def test_int8_rglru_scan_takes_the_whole_rows_scale(runs):
    """Under ``int8-fused`` a rank's RG-LRU scan over its channels is bit for
    bit the columns of the one-device scan over the whole width: its rows
    are quantized with the whole row's scale (the max over ``model`` of the
    ranks' row absmax), as the reference quantizes the whole row.  The same
    channels against their own row absmax give other values, so the check
    sees the scale."""
    inp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in scan_inputs().items()}
    whole = rglru.rglru_scan({k: inp[k] for k in ("wa", "ba", "wx", "bx", "lam")}, inp["x"],
                             "int8-fused")
    moved = 0.0
    for out in _ranks(runs, "row_scale", 2):
        a, b = out["cols"]
        assert torch.equal(torch.tensor(out["y"]), whole[..., a:b])
        moved = max(moved, float((torch.tensor(out["own_scale"]) - whole[..., a:b]).abs().max()))
    assert moved > 1e-4


def test_int8_quantizer_with_a_row_absmax_is_the_whole_rows():
    """``ops._quantize_q8`` given the absmax of a wider row: the bytes and
    scales of the whole row's quantization, its columns."""
    from repro_torch.kernels import ops

    x = torch.from_numpy(scan_inputs()["x"].astype(np.float32))
    q, s = R.quantize_int8_ref(x, 0.5)
    for cols in (slice(0, 32), slice(32, 64), slice(16, 48)):
        part = x[..., cols]
        got_q, got_s = ops._quantize_q8(part, x.abs().amax(dim=-1, keepdim=True))
        assert torch.equal(got_q, q[..., cols]) and torch.equal(got_s, s)


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process (1 x 1) run of rwkv6-7b: (losses, grad norms)."""
    model = get_model(smoke_config("rwkv6-7b"))
    opt = sgd_momentum()
    step = make_train_step(model, opt, lambda s: torch.tensor(LR))
    params = params_from_jax(numpy_params("rwkv6-7b"), "cpu")
    state = opt.init(params)
    losses, norms = [], []
    for b in batches("rwkv6-7b"):
        params, state, met = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms


def test_zero3_composed_with_tp_equals_the_one_process_run(runs, one_process):
    """rwkv6-7b under ``fsdp=True`` at (2 x 2): a rank holds ``embed``
    halved over ``data`` and its heads, FFN columns and vocabulary halved
    over ``model``; its losses and gradient norms equal the (2 x 2) run
    without ZeRO-3 bit for bit and the port's one-process run at rtol 1e-5
    (3e-3 after step 1, as the module doc says)."""
    cfg = smoke_config("rwkv6-7b")
    zero = _ranks(runs, key("rwkv6-7b", "f32", (2, 2), "-fsdp"), 4)
    plain = _ranks(runs, key("rwkv6-7b", "f32", (2, 2)), 4)
    for out, other in zip(zero, plain):
        assert (out["losses"], out["grad_norms"]) == (other["losses"], other["grad_norms"])
        np.testing.assert_allclose(out["losses"][0], one_process[0][0], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"][0], one_process[1][0], rtol=1e-5)
        np.testing.assert_allclose(out["losses"], one_process[0], rtol=3e-3)
        np.testing.assert_allclose(out["grad_norms"], one_process[1], rtol=3e-3)
    shapes = zero[0]["shapes"]
    d = cfg.d_model
    assert shapes["blocks/tmix/wr"] == [cfg.n_layers, d // 2, d // 2]
    assert shapes["blocks/tmix/wa"] == [cfg.n_layers, d // 2, cfg.decay_lora]
    assert shapes["embedding/table"] == [cfg.vocab // 2, d // 2]
    # the leaves replicated over model are the data coordinate's pieces
    for group in (zero[:2], zero[2:]):
        assert len({out["replicated_digest"] for out in group}) == 1


# ---------------------------------------------------------------------------
# the closed form of a step's collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=lambda c: key(*c))
def test_a_step_moves_the_closed_form_collectives(runs, case):
    """The last step's collectives equal ``roofline.collectives.tp_step_ops``
    op for op: rwkv6's mu gathers, decay-LoRA copy-in and r gather,
    recurrentgemma's recurrent blocks (and under ``int8-fused`` the row
    scale's all-reduce), whisper's encoder output copy-in and
    cross-attention, beside the attention, MLP, vocabulary and ``data``
    collectives of the dense count."""
    arch, prec, (data, model_ways) = case
    cfg = smoke_config(arch).with_(train_precision=prec)
    model = get_model(cfg)
    plan = build_sharding_plan(model, adamw(), mesh=SH.ProcessMesh(torch.device("cpu"),
                                                                   (data, model_ways)),
                               global_rows=ROWS, seq_len=SEQ)
    shapes = _flat(model.init_params(abstract=True)[0])
    grad_bytes = [int(np.prod(lay.shard_shape(tuple(shapes[path].shape)))) * 4
                  for path, lay in sorted(SH.iter_layouts(plan.params))]
    patches = N_PATCH if cfg.family == "vlm" else 0
    for r, out in enumerate(_ranks(runs, key(*case), data * model_ways)):
        want = sorted(tp_step_ops(cfg, ROWS // data, SEQ, model_ways, data=data,
                                  model_index=r % model_ways, grad_bytes=grad_bytes,
                                  patches=patches))
        assert sorted(map(tuple, out["ops"])) == want
        assert collective_bytes(map(tuple, out["ops"])) == collective_bytes(want)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _saved_state(io):
    """The rwkv6 (2 x 2) ZeRO-3 run's state after its AdamW step, assembled
    from the four ranks' pieces: {'params/…' | 'mu/…' | 'nu/…': whole array}."""
    model = get_model(smoke_config("rwkv6-7b").with_(fsdp=True))
    plan = build_sharding_plan(model, adamw(), mesh=SH.ProcessMesh(torch.device("cpu"),
                                                                   (2, 2)),
                               global_rows=ROWS, seq_len=SEQ)
    pieces = [dict(np.load(os.path.join(io, f"pieces.{r}.npz"))) for r in range(4)]
    lays = dict(SH.iter_layouts(plan.params))
    whole = {}
    for name in pieces[0]:
        lay = lays[name.split("/", 1)[1]]
        whole[name] = lay.assemble([torch.from_numpy(p[name]) for p in pieces]).numpy()
    return model, whole


def test_lru_pieces_checkpoint_restores_whole(runs):
    """The chunked checkpoint of the rwkv6 (2 x 2) ZeRO-3 ranks restores
    whole in the port, bit for bit the state the ranks held; a leaf sharded
    over ``data`` and ``lru`` has four chunks, an ``lru`` vector over
    ``model`` alone two."""
    io = runs[0]
    model, want = _saved_state(io)
    with open(os.path.join(io, "ckpt", "step_0000000001", "manifest.json")) as f:
        entries = json.load(f)["entries"]
    assert len(entries["params/blocks/tmix/wr"]["chunks"]) == 4
    assert len(entries["opt/nu/blocks/tmix/wk"]["chunks"]) == 4
    assert len(entries["params/blocks/tmix/mu_r"]["chunks"]) == 2
    assert "chunks" not in entries["params/blocks/ln1/scale"]
    like, _ = model.init_params(abstract=True)
    whole, meta = restore(os.path.join(io, "ckpt"), {"params": like, "opt": adamw().init(like)})
    assert meta["step"] == 1 and whole["opt"].step == 1
    trees = {"params": whole["params"], "mu": whole["opt"].mu, "nu": whole["opt"].nu}
    for name, arr in want.items():
        tree, path = name.split("/", 1)
        np.testing.assert_array_equal(_flat(trees[tree])[path].numpy(), arr)


def test_the_reference_restores_the_lru_checkpoint(runs):
    io = runs[0]
    model, want = _saved_state(io)
    like = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                                  model.init_params(abstract=True)[0])
    jlike = {"params": like, "opt": JOptState(step=jnp.int32(0), mu=like, nu=like)}
    tree, meta = JM.restore(os.path.join(io, "ckpt"), jlike, step=1)
    assert meta["step"] == 1 and int(tree["opt"].step) == 1
    trees = {"params": tree["params"], "mu": tree["opt"].mu, "nu": tree["opt"].nu}
    for name, arr in want.items():
        tree_name, path = name.split("/", 1)
        np.testing.assert_array_equal(np.asarray(_flat(trees[tree_name])[path]), arr)
