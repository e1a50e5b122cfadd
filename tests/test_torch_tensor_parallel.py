"""Tensor and expert parallelism over the ``model`` axis on the CPU: the
dense and MoE decoders' training step on a ``(data, model)`` ``DeviceMesh``
of ``gloo`` ranks (``make_host_mesh`` + ``make_spmd_train_step(plan=)``,
the counterpart of the reference's ``set_mesh`` + ``jit(make_train_step)``).

One module fixture launches every run at once, each rendezvous a file store
under the test's temporary directory:

* four ranks; first two of them as a world-2 group at mesh (1 x 2), then
  all four at (2 x 2) and (1 x 4):
  - the smoke deepseek-7b and minitron-8b (2 KV heads: at ``model`` = 4 the
    KV weights stay whole) for 3 SGD-momentum steps from one numpy weight
    tree, and at (2 x 2) deepseek-7b under ``fsdp=True`` (ZeRO-3 over
    ``data`` composed with the ``model`` shards), 3 steps and then one
    AdamW step saved as a chunked checkpoint;
  - the smoke qwen3-moe's MoE layer (capacity 8.0) through the
    group-local expert-parallel path at (1 x 2), (2 x 2) and (2 x 2) with
    the batch rows over ``model`` too: forward, aux loss and the gradients
    through the output and through the aux loss apart; and at (1 x 4)
    under capacity overflow (factor 0.01), with each rank's kept slots;
* the reference on four fake CPU devices: ``jit(make_train_step)`` of the
  two dense configs on one device; ``moe_mlp`` under ``set_mesh`` at the
  three EP meshes (its ``_moe_mlp_local``) and single-program (``dense``),
  each with its ``vjp``.

Held: dense TP at every mesh equals the reference's single-device step
(loss and gradient norm, rtol 1e-5), the leaves replicated over ``model``
equal on every rank; (2 x 2) under ``fsdp`` equals the replicated (1 x 1)
run; EP equals the reference's local path and its single program (forward
5e-4, aux 1e-6, gradients 1e-5 of their largest) with the router's two
gradient parts apart; under overflow the ranks' kept slots are the port's
one-process fused path's, exactly; the (2 x 2) checkpoint restores whole
and at (1 x 2) bit for bit, in both packages.  In process: the
warn-once contract of ``with_logical_constraint`` and ``check_plan``'s
verdicts.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings

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
from repro_torch.kernels import fused_moe as FM
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.roofline.collectives import collective_bytes, tp_step_ops
from repro_torch.train.steps import build_sharding_plan, make_train_step

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
DENSE = ("deepseek-7b", "minitron-8b")
DENSE_MESHES = ((1, 2), (2, 2), (1, 4))
MOE_MESHES = ((1, 2), (2, 2))
EP_CASES = (("1x2", (1, 2), False), ("2x2", (2, 2), False), ("2x2-over", (2, 2), True))
STEPS, LR, ROWS, SEQ = 3, 1e-2, 4, 16
MOE_ARCH = "qwen3-moe-30b-a3b"


def numpy_params(arch, seed=0):
    """A float32 parameter tree of ``arch``'s smoke config with the leaves of
    the reference's abstract init, drawn with numpy: norm scales 1,
    embedding tables N(0, 1), every projection N(0, 1/fan_in) over the axes
    it contracts (as ``tests/test_torch_families.py`` draws them)."""
    abstract, _ = jax_get_model(jax_smoke_config(arch)).init_params(abstract=True)
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "scale":
            return np.ones(shape)
        if name == "table":
            return rng.standard_normal(shape)
        fan_in = shape[1] * (shape[2] if name == "wo" and len(shape) == 4 else 1)
        return rng.standard_normal(shape) / np.sqrt(fan_in)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v.shape).astype(np.float32)
                for k, v in node.items()}

    return walk(abstract)


def batches(vocab, seed=7):
    out = []
    for i in range(STEPS):
        toks = np.random.default_rng(seed + i).integers(0, vocab, (ROWS, SEQ + 1))
        mask = np.ones((ROWS, SEQ), np.float32)
        mask[-1, SEQ // 2:] = 0.0
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32), "loss_mask": mask})
    return out


def moe_inputs(seed=3):
    """The MoE layer's weights, input and output cotangent (smoke qwen3-moe)."""
    cfg = smoke_config(MOE_ARCH)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, E)) / np.sqrt(d),
            "wi_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
            "wi_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
            "wo": rng.standard_normal((E, f, d)) / np.sqrt(f),
            "x": rng.standard_normal((4, 16, d)), "cot": rng.standard_normal((4, 16, d)),
            "x_overflow": rng.standard_normal((4, 64, d))}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


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
from repro_torch.kernels import fused_moe as FM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.optim.optimizers import tree_map
from repro_torch.train.steps import (build_sharding_plan, make_spmd_train_step, mesh_rank,
                                     tree_leaves_sorted, _sorted_paths)

STEPS, LR, ROWS, SEQ = 3, 1e-2, 4, 16
inputs = dict(np.load(f"{io}/inputs.npz"))


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


def join(world):
    dist.init_process_group("gloo", init_method=f"file://{io}/store-{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))


def leave(name, out):
    with open(f"{io}/{name}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def train(arch, data, model_ways, *, fsdp=False, ckpt=None):
    cfg = smoke_config(arch).with_(fsdp=fsdp)
    m = get_model(cfg)
    mesh = make_host_mesh(data=data, model=model_ways)
    plan = SH.check_plan(build_sharding_plan(m, adamw(), mesh=mesh, global_rows=ROWS,
                                             seq_len=SEQ), data * model_ways)
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
        save_process(ckpt, 1, tree, process_index=rank, num_processes=dist.get_world_size(),
                     layouts=lay, coord=r, metadata={"step": 1})
        dist.barrier()
        if rank == 0:
            finalize_process_save(ckpt, 1, num_processes=dist.get_world_size())
        pieces = {"params/" + p: t for p, t in _flat_items(params)}
        pieces.update({"mu/" + p: t for p, t in _flat_items(state.mu)})
        pieces.update({"nu/" + p: t for p, t in _flat_items(state.nu)})
        np.savez(f"{io}/pieces.{rank}.npz", **{k: v.numpy() for k, v in pieces.items()})
    return out


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_items(v, path)
        else:
            yield path, v


def ep(data, model_ways, over, cap=8.0, x_key="x"):
    cfg = smoke_config("qwen3-moe-30b-a3b").with_(capacity_factor=cap)
    mesh = make_host_mesh(data=data, model=model_ways)
    rules = SH.make_rules(extra={"batch": ("pod", "data", "model")} if over else None)
    g, j = (int(c) for c in mesh.get_coordinate())
    E_loc = cfg.n_experts // model_ways
    mine = slice(j * E_loc, (j + 1) * E_loc)
    w = {"router": torch.from_numpy(inputs["moe/router"][:, mine]),
         **{k: torch.from_numpy(inputs["moe/" + k][mine]) for k in ("wi_gate", "wi_up", "wo")}}
    x, cot = torch.from_numpy(inputs["moe/" + x_key]), torch.from_numpy(inputs["moe/cot"])
    n = x.shape[0] // data // (model_ways if over else 1)
    row0 = (g * model_ways + j) * n if over else g * n
    x = x[row0:row0 + n]
    cot = cot[row0:row0 + n] if x_key == "x" else torch.zeros_like(x)
    out = {}
    with SH.use_rules(rules), SH.use_mesh(mesh):
        tp = tensor.plan_for(cfg)
        for part, c_out, c_aux in (("out", cot, 0.0), ("aux", cot * 0, 1.0 / data)):
            p = {k: v.clone().requires_grad_() for k, v in w.items()}
            xx = x.clone().requires_grad_()
            y, aux = moe.moe_mlp(p, xx, cfg, tp)
            leaves = [xx] + [p[k] for k in sorted(p)]
            grads = torch.autograd.grad((y * c_out).sum() + c_aux * aux, leaves)
            grads = list(grads)
            if data > 1:     # the step's reduction of a data-replicated leaf
                for t in grads[1:]:
                    dist.all_reduce(t, group=mesh.get_group("data"))
            out[part] = {name: t.tolist() for name, t in zip(["x"] + sorted(p), grads)}
            out["y"], out["aux_value"] = y.detach().tolist(), float(aux.detach())
        if cap < 1.0:
            xg = x.reshape(-1, x.shape[-1])
            C = moe.expert_capacity(xg.shape[0], cfg.n_experts, cfg.experts_per_token, cap)
            slot_tok = FM.moe_routing(xg, torch.from_numpy(inputs["moe/router"]),
                                      cfg.experts_per_token, C)[0][j * E_loc * C:(j + 1) * E_loc * C]
            out["kept"] = sorted((int(t), j * E_loc + s // C) for s, t in
                                 enumerate(slot_tok[:, 0].tolist()) if t < xg.shape[0])
    out["rows"] = [row0, row0 + n]
    return out


if rank < 2:
    join(2)
    out = {f"{arch}/1x2": train(arch, 1, 2) for arch in ("deepseek-7b", "minitron-8b",
                                                         "qwen3-moe-30b-a3b")}
    out["ep/1x2"] = ep(1, 2, False)
    # rows over model run the MoE layer alone: a whole model refuses them
    cfg = smoke_config("deepseek-7b")
    with SH.use_rules(SH.make_rules(extra={"batch": ("pod", "data", "model")})), \
            SH.use_mesh(make_host_mesh(data=1, model=2)):
        try:
            get_model(cfg).forward({}, torch.zeros(1, 4, dtype=torch.long))
            out["over_model_refused"] = ""
        except NotImplementedError as exc:
            out["over_model_refused"] = str(exc)
    leave("world2", out)
join(4)
out = {}
for arch in ("deepseek-7b", "minitron-8b"):
    out[f"{arch}/2x2"] = train(arch, 2, 2)
    out[f"{arch}/1x4"] = train(arch, 1, 4)
out["qwen3-moe-30b-a3b/2x2"] = train("qwen3-moe-30b-a3b", 2, 2)
out["deepseek-7b/2x2-fsdp"] = train("deepseek-7b", 2, 2, fsdp=True, ckpt=f"{io}/ckpt")
out["ep/2x2"] = ep(2, 2, False)
out["ep/2x2-over"] = ep(2, 2, True)
out["ep/1x4-overflow"] = ep(1, 4, False, cap=0.01, x_key="x_overflow")
leave("world4", out)
"""

JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh, set_mesh
from repro.configs import smoke_config
from repro.distributed.sharding import make_rules, set_rules
from repro.models import moe
from repro.models.api import get_model
from repro.optim import sgd_momentum
from repro.train import steps as JS

io = sys.argv[1]
STEPS, LR = 3, 1e-2
inputs = dict(np.load(io + "/inputs.npz"))


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
for arch in ("deepseek-7b", "minitron-8b"):
    m = get_model(smoke_config(arch))
    opt = sgd_momentum()
    step = jax.jit(JS.make_train_step(m, opt, lambda s: jnp.float32(LR)))
    p = tree_of(arch)
    s = opt.init(p)
    losses, norms = [], []
    for i in range(STEPS):
        b = {k: jnp.asarray(inputs[f"batch{arch}/{i}/{k}"]) for k in ("tokens", "labels",
                                                                       "loss_mask")}
        p, s, met = step(p, s, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    out[arch] = {"losses": losses, "grad_norms": norms}

cfg = smoke_config("qwen3-moe-30b-a3b").with_(capacity_factor=8.0)
w = {k: jnp.asarray(inputs["moe/" + k]) for k in ("router", "wi_gate", "wi_up", "wo")}
x, cot = jnp.asarray(inputs["moe/x"]), jnp.asarray(inputs["moe/cot"])


def layer(p, x):
    return moe.moe_mlp(p, x, cfg)


@jax.jit
def run(p, x, cot):
    (y, aux), vjp = jax.vjp(layer, p, x)
    g_out = vjp((cot, jnp.float32(0.0)))
    g_aux = vjp((jnp.zeros_like(cot), jnp.float32(1.0)))
    return y, aux, g_out, g_aux


def record(res):
    y, aux, g_out, g_aux = res
    parts = {}
    for name, (gp, gx) in (("out", g_out), ("aux", g_aux)):
        parts[name] = {"x": np.asarray(gx).tolist(),
                       **{k: np.asarray(gp[k]).tolist() for k in sorted(gp)}}
    return {"y": np.asarray(y).tolist(), "aux_value": float(aux), **parts}


moe.MOE_IMPL = "dense"
out["single"] = record(run(w, x, cot))
moe.MOE_IMPL = "auto"
for name, shape, over in (("1x2", (1, 2), False), ("2x2", (2, 2), False),
                          ("2x2-over", (2, 2), True)):
    if over:
        set_rules(make_rules(extra={"batch": ("pod", "data", "model")}))
    with set_mesh(make_mesh(shape, ("data", "model"))):
        # a fresh function a case: jit's cache would hand the over-model case
        # the (2 x 2) trace, traced under the other batch rule
        out[name] = record(jax.jit(lambda *a: run.__wrapped__(*a))(w, x, cot))
    set_rules(make_rules())
with open(io + "/reference.json", "w") as f:
    json.dump(out, f)
"""


def _spawn(code, args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (io dir, {part: [per-rank outputs]}, the reference's outputs)."""
    io = str(tmp_path_factory.mktemp("tp"))
    flat = {}
    for arch in DENSE + (MOE_ARCH,):
        flat.update({f"{arch}/{k}": v for k, v in _flat(numpy_params(arch)).items()})
        for i, b in enumerate(batches(smoke_config(arch).vocab)):
            flat.update({f"batch{arch}/{i}/{k}": v for k, v in b.items()})
    flat.update({f"moe/{k}": v.astype(np.float32) for k, v in moe_inputs().items()})
    np.savez(os.path.join(io, "inputs.npz"), **flat)
    procs = [_spawn(JAX_SIDE, [io], {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
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
    for part, n in (("world2", 2), ("world4", 4)):
        out[part] = []
        for r in range(n):
            with open(os.path.join(io, f"{part}.{r}.json")) as f:
                out[part].append(json.load(f))
    with open(os.path.join(io, "reference.json")) as f:
        ref = json.load(f)
    return io, out, ref


def _ranks(runs, key):
    part = "world2" if key.endswith("1x2") else "world4"
    return [out[key] for out in runs[1][part]]


# ---------------------------------------------------------------------------
# dense tensor parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("mesh", DENSE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dense_tp_equals_the_reference_train_step(runs, arch, mesh):
    """Three SGD-momentum steps at ``mesh``: every rank's loss and gradient
    norm equal the reference's single-device ``jit(make_train_step)``
    (rtol 1e-5); the ranks agree, and the leaves replicated over ``model``
    are bit for bit the same on every rank."""
    want = runs[2][arch]
    ranks = _ranks(runs, f"{arch}/{mesh[0]}x{mesh[1]}")
    for out in ranks:
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"], want["grad_norms"], rtol=1e-5)
        assert out["losses"] == ranks[0]["losses"]
    assert len({out["replicated_digest"] for out in ranks}) == 1


CLOSED_FORM_CASES = [(a, m) for a in DENSE for m in DENSE_MESHES] + \
    [(MOE_ARCH, m) for m in MOE_MESHES]


@pytest.mark.parametrize("arch,mesh", CLOSED_FORM_CASES,
                         ids=lambda c: c if isinstance(c, str) else f"{c[0]}x{c[1]}")
def test_a_step_moves_the_closed_form_collectives(runs, arch, mesh):
    """The last step's collectives equal ``roofline.collectives.tp_step_ops``
    op for op: per layer the attention's and the MLP's activation
    all-reduces (forward twice under remat, backward once), whole KV heads'
    gradients at (1 x 4) for minitron-8b, the vocabulary-parallel embedding,
    head and loss, the MoE layer's router gather and combine, and at
    (2 x 2) the routing statistics' mean and the ``data`` group's gradient
    and loss-sum all-reduces."""
    data, model_ways = mesh
    cfg = smoke_config(arch)
    model = get_model(cfg)
    plan = build_sharding_plan(model, adamw(), mesh=SH.ProcessMesh(torch.device("cpu"), mesh),
                               global_rows=ROWS, seq_len=SEQ)
    shapes = _flat(model.init_params(abstract=True)[0])
    grad_bytes = [int(np.prod(lay.shard_shape(tuple(shapes[path].shape)))) * 4
                  for path, lay in sorted(SH.iter_layouts(plan.params))]
    for r, out in enumerate(_ranks(runs, f"{arch}/{data}x{model_ways}")):
        want = sorted(tp_step_ops(cfg, ROWS // data, SEQ, model_ways, data=data,
                                  model_index=r % model_ways, grad_bytes=grad_bytes))
        assert sorted(map(tuple, out["ops"])) == want
        assert collective_bytes(map(tuple, out["ops"])) == collective_bytes(want)


@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_ep_training_equals_the_one_process_run(runs, replicated, mesh):
    """The smoke qwen3-moe (8 experts, 4 query heads over 2 KV heads) for
    3 steps at ``mesh``: each rank holds 8 / m experts and runs the
    group-local EP layer; losses and gradient norms equal the port's
    one-process fused run (rtol 1e-5), the ranks agree, and the leaves
    replicated over ``model`` are the same on every rank."""
    ranks = _ranks(runs, f"{MOE_ARCH}/{mesh[0]}x{mesh[1]}")
    cfg = smoke_config(MOE_ARCH)
    for out in ranks:
        np.testing.assert_allclose(out["losses"], replicated[MOE_ARCH][0], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"], replicated[MOE_ARCH][1], rtol=1e-5)
        assert out["losses"] == ranks[0]["losses"]
        assert out["shapes"]["blocks/moe/wi_gate"][1] == cfg.n_experts // mesh[1]
        assert out["shapes"]["blocks/moe/router"][2] == cfg.n_experts // mesh[1]
    assert len({out["replicated_digest"] for out in ranks}) == 1


@pytest.mark.parametrize("arch", DENSE)
def test_a_rank_holds_its_heads_columns_and_vocabulary_rows(runs, arch):
    """At (1 x 4) a rank holds 1 of 4 query heads, a quarter of the FFN
    columns and of the vocabulary; deepseek-7b's 4 KV heads are split,
    minitron-8b's 2 stay whole."""
    cfg = smoke_config(arch)
    shapes = _ranks(runs, f"{arch}/1x4")[0]["shapes"]
    hd, L = cfg.resolved_head_dim(), cfg.n_layers
    assert shapes["blocks/attn/wq"] == [L, cfg.d_model, 1, hd]
    kv = cfg.n_kv_heads // 4 if cfg.n_kv_heads % 4 == 0 else cfg.n_kv_heads
    assert shapes["blocks/attn/wk"] == [L, cfg.d_model, kv, hd]
    assert shapes["blocks/mlp/wo"][1] == cfg.d_ff // 4
    assert shapes["embedding/table"] == [cfg.vocab // 4, cfg.d_model]
    assert shapes["blocks/ln1/scale"] == [L, cfg.d_model]


@pytest.fixture(scope="module")
def replicated():
    """The port's one-process (1 x 1) run of the dense configs: {arch:
    (losses, grad norms)}."""
    out = {}
    for arch in DENSE + (MOE_ARCH,):
        model = get_model(smoke_config(arch))
        opt = sgd_momentum()
        step = make_train_step(model, opt, lambda s: torch.tensor(LR))
        params = params_from_jax(numpy_params(arch), "cpu")
        state = opt.init(params)
        losses, norms = [], []
        for b in batches(smoke_config(arch).vocab):
            params, state, met = step(params, state, {k: torch.from_numpy(v)
                                                      for k, v in b.items()})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out[arch] = (losses, norms)
    return out


def test_zero3_composed_with_tp_equals_the_replicated_run(runs, replicated):
    """deepseek-7b under ``fsdp=True`` at (2 x 2): a rank holds ``embed``
    halved over ``data`` and heads, FFN columns and vocabulary halved over
    ``model``; its losses and gradient norms equal the (2 x 2) run without
    ZeRO-3 bit for bit and the replicated one-process run at rtol 1e-5."""
    cfg = smoke_config("deepseek-7b")
    zero = _ranks(runs, "deepseek-7b/2x2-fsdp")
    for out, plain in zip(zero, _ranks(runs, "deepseek-7b/2x2")):
        assert (out["losses"], out["grad_norms"]) == (plain["losses"], plain["grad_norms"])
        np.testing.assert_allclose(out["losses"], replicated["deepseek-7b"][0], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"], replicated["deepseek-7b"][1], rtol=1e-5)
    shapes = zero[0]["shapes"]
    hd = cfg.resolved_head_dim()
    assert shapes["blocks/attn/wq"] == [cfg.n_layers, cfg.d_model // 2, cfg.n_heads // 2, hd]
    assert shapes["embedding/table"] == [cfg.vocab // 2, cfg.d_model // 2]
    assert len({out["replicated_digest"] for out in zero}) == 1


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def _piece(name, ref, out, E_loc, j):
    """The reference's whole gradient cut to what the rank holds."""
    ref = np.asarray(ref)
    if name == "x":
        return ref[out["rows"][0]:out["rows"][1]]
    if name == "router":
        return ref[:, j * E_loc:(j + 1) * E_loc]
    return ref[j * E_loc:(j + 1) * E_loc]


def _check_ep(ranks, want, mesh, parts=("out", "aux"), names=None):
    E_loc = smoke_config(MOE_ARCH).n_experts // mesh[1]
    for r, out in enumerate(ranks):
        j = r % mesh[1]
        rows = slice(*out["rows"])
        assert np.abs(np.asarray(out["y"]) - np.asarray(want["y"])[rows]).max() < 5e-4
        assert abs(out["aux_value"] - want["aux_value"]) < 1e-6
        for part in parts:
            for name in names or sorted(out[part]):
                ref = _piece(name, want[part][name], out, E_loc, j)
                scale = max(np.abs(np.asarray(want[part][name])).max(), 1e-30)
                np.testing.assert_allclose(np.asarray(out[part][name]), ref, rtol=0,
                                           atol=1e-5 * scale, err_msg=f"{part} {name}")


@pytest.mark.parametrize("case", EP_CASES, ids=lambda c: c[0])
def test_ep_equals_the_reference_local_path(runs, case):
    """The group-local EP layer: each rank's output rows, the aux loss and
    the gradients of its input rows, its router columns and its experts'
    weights (through the output and through the aux loss) equal the
    reference's ``_moe_mlp_local`` under ``set_mesh`` on the same mesh."""
    name, mesh, _ = case
    _check_ep(_ranks(runs, f"ep/{name}"), runs[2][name], mesh)


@pytest.mark.parametrize("case", EP_CASES, ids=lambda c: c[0])
def test_router_gradient_parts_equal_the_single_program(runs, case):
    """The router's gradient through the combine (each rank's part, summed
    over ``model``) and through the aux loss (whole on every rank, counted
    once) each equal the reference's single-program gradient apart; the
    layer's output and input gradient too."""
    name, mesh, _ = case
    _check_ep(_ranks(runs, f"ep/{name}"), runs[2]["single"], mesh, names=("router", "x"))


def test_a_whole_model_refuses_batch_rows_over_model(runs):
    """The over-model batch layout runs the MoE layer alone (above); a
    whole model's forward under it raises, naming what is left of item 19."""
    for out in runs[1]["world2"]:
        assert "second half of ROADMAP item 19" in out["over_model_refused"]


def test_ep_under_capacity_overflow_keeps_the_fused_slots(runs):
    """Capacity factor 0.01 at (1 x 4): 8 slots an expert for 512 token
    copies.  The slots the four ranks keep are those of the port's
    one-process fused path, exactly (one group: the same capacity), and the
    summed output is within 5e-4 of it; drops really happen."""
    inp = moe_inputs()
    cfg = smoke_config(MOE_ARCH).with_(capacity_factor=0.01)
    p = {k: torch.from_numpy(inp[k].astype(np.float32))
         for k in ("router", "wi_gate", "wi_up", "wo")}
    x = torch.from_numpy(inp["x_overflow"].astype(np.float32))
    want, _ = moe.moe_mlp(p, x, cfg)
    xf = x.reshape(-1, cfg.d_model)
    C = moe.expert_capacity(xf.shape[0], cfg.n_experts, cfg.experts_per_token,
                            cfg.capacity_factor)
    assert C == 8
    slot_tok = FM.moe_routing(xf, p["router"], cfg.experts_per_token, C)[0][:, 0].tolist()
    kept = sorted((t, s // C) for s, t in enumerate(slot_tok) if t < xf.shape[0])
    assert len(kept) < xf.shape[0] * cfg.experts_per_token
    ranks = _ranks(runs, "ep/1x4-overflow")
    got = sorted(tuple(k) for out in ranks for k in out["kept"])
    assert got == kept
    for out in ranks:
        assert np.abs(np.asarray(out["y"]) - want.numpy()).max() < 5e-4
    uncapped, _ = moe.moe_mlp(p, x, cfg.with_(capacity_factor=8.0))
    assert float((uncapped - want).abs().max()) > 1e-3


@pytest.mark.parametrize("ways", [2, 4])
def test_the_ranks_local_parts_sum_to_the_fused_layer(ways):
    """``ops.fused_moe_local`` on the CPU (its plain version): each part
    equals ``R.fused_moe_local_ref``, forward and gradients, and the parts
    of the ``ways`` experts' ranks sum to ``ops.fused_moe_mlp``'s output
    (copies sent to other ranks' experts add nothing), including dropped
    copies at capacity 8."""
    inp = moe_inputs()
    cfg = smoke_config(MOE_ARCH)
    w = {k: torch.from_numpy(inp[k].astype(np.float32)) for k in
         ("router", "wi_gate", "wi_up", "wo")}
    x = torch.from_numpy(inp["x_overflow"].astype(np.float32)).reshape(-1, cfg.d_model)
    k, C, E_loc = cfg.experts_per_token, 8, cfg.n_experts // ways
    whole, _ = ops.fused_moe_mlp(x, w["router"], w["wi_gate"], w["wi_up"], w["wo"], k=k,
                                 capacity=C)
    total = torch.zeros_like(whole)
    g = torch.from_numpy(inp["x_overflow"][..., :].astype(np.float32)).reshape(x.shape).flip(0)
    for j in range(ways):
        mine = slice(j * E_loc, (j + 1) * E_loc)
        args = [t.clone().requires_grad_() for t in
                (x, w["router"], w["wi_gate"][mine], w["wi_up"][mine], w["wo"][mine])]
        got = ops.fused_moe_local(*args, k=k, capacity=C, first_expert=j * E_loc)
        want = R.fused_moe_local_ref(*args, k, C, j * E_loc)
        assert torch.equal(got, want)
        for a, b in zip(torch.autograd.grad((got * g).sum(), args),
                        torch.autograd.grad((want * g).sum(), args)):
            assert torch.equal(a, b)
        total += got.detach()
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the plan and the constraint
# ---------------------------------------------------------------------------


def test_constraint_mismatch_warns_once():
    """Mirrors the reference's ``test_constraint_mismatch_warns_once``: a
    rank-mismatched constraint returns its input with ONE RuntimeWarning;
    a dim the model axis does not divide warns once and must be whole;
    a rank holding another piece than the layout says raises; outside a
    mesh, or with ``constrain=False``, nothing is checked."""
    SH.reset_constraint_warnings()
    x = torch.zeros(4)
    with SH.use_mesh(SH.ProcessMesh(torch.device("cpu"))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            y = SH.with_logical_constraint(x, "batch", "heads")
            assert y is x
            assert len([r for r in w if r.category is RuntimeWarning]) == 1
            SH.with_logical_constraint(x, "batch", "heads")
            assert len([r for r in w if r.category is RuntimeWarning]) == 1
            SH.with_logical_constraint(torch.zeros(4, 4), "batch", None)
            assert len([r for r in w if r.category is RuntimeWarning]) == 1
    mesh = SH.ProcessMesh(torch.device("cpu"), (1, 2))
    with SH.use_mesh(mesh), SH.logical_sizes({"act_heads": 4, "act_kv_heads": 3}):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            SH.with_logical_constraint(torch.zeros(2, 5, 2, 8), "batch", "seq", "act_heads", None)
            for _ in range(2):
                SH.with_logical_constraint(torch.zeros(2, 5, 3, 8), "batch", "seq",
                                           "act_kv_heads", None)
            assert len([r for r in w if r.category is RuntimeWarning]) == 1
        with pytest.raises(ValueError, match="layout contract"):
            SH.with_logical_constraint(torch.zeros(2, 5, 4, 8), "batch", "seq", "act_heads",
                                       None)
        with SH.use_rules(SH.make_rules(), constrain=False):
            SH.with_logical_constraint(torch.zeros(2, 5, 4, 8), "batch", "seq", "act_heads",
                                       None)
    SH.with_logical_constraint(torch.zeros(2, 5, 4, 8), "batch", "seq", "act_heads", None)


PLAN_VERDICTS = [
    ("deepseek-7b", False, (1, 2), None),
    ("minitron-8b", False, (1, 4), None),
    ("deepseek-7b", True, (2, 2), None),
    ("qwen3-moe-30b-a3b", False, (1, 4), None),
    ("dbrx-132b", True, (2, 2), None),
    ("rwkv6-7b", False, (1, 2), None),
    ("recurrentgemma-2b", False, (1, 2), None),
    ("whisper-medium", False, (1, 2), None),
    ("qwen2-vl-7b", False, (1, 2), None),
    ("deepseek-7b", False, (1, 8), None),
    ("recurrentgemma-2b", False, (1, 4), None),
    ("rwkv6-7b", False, (1, 8), "whole heads"),
]


@pytest.mark.parametrize("case", PLAN_VERDICTS, ids=lambda c: f"{c[0]}-{c[2][0]}x{c[2][1]}")
def test_check_plan_verdicts(case):
    """``check_plan`` passes every family's plans over ``model`` (ZeRO-3
    over ``data`` beside them), query heads the axis does not divide among
    them (the smoke deepseek-7b's 4 heads over 8 ranks, recurrentgemma-2b's
    2 over 4: whole weights, a padded split of the heads), and refuses an
    ``lru`` split that cuts an RWKV head (the smoke rwkv6's 64 channels of
    16 a head over 8 ranks) and several devices a process."""
    arch, fsdp, (data, model_ways), refusal = case
    plan = build_sharding_plan(get_model(smoke_config(arch).with_(fsdp=fsdp)), adamw(),
                               mesh=SH.ProcessMesh(torch.device("cpu"), (data, model_ways)),
                               global_rows=8, seq_len=16)
    assert any(lay.model_dim is not None for _, lay in SH.iter_layouts(plan.params))
    if refusal is None:
        assert SH.check_plan(plan, data * model_ways) is plan
        with pytest.raises(NotImplementedError, match="several devices a process"):
            SH.check_plan(plan, 1)
    else:
        with pytest.raises(NotImplementedError, match=refusal) as err:
            SH.check_plan(plan, data * model_ways)
        assert "second half of ROADMAP item 19" in str(err.value)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _saved_state(io):
    """The (2 x 2) run's state after its AdamW step, assembled from the four
    ranks' pieces: {'params/…' | 'mu/…' | 'nu/…': whole array}."""
    model = get_model(smoke_config("deepseek-7b").with_(fsdp=True))
    plan = build_sharding_plan(model, adamw(), mesh=SH.ProcessMesh(torch.device("cpu"),
                                                                   (2, 2)),
                               global_rows=ROWS, seq_len=SEQ)
    pieces = [dict(np.load(os.path.join(io, f"pieces.{r}.npz"))) for r in range(4)]
    lays = dict(SH.iter_layouts(plan.params))
    whole = {}
    for key in pieces[0]:
        lay = lays[key.split("/", 1)[1]]
        whole[key] = lay.assemble([torch.from_numpy(p[key]) for p in pieces]).numpy()
    return model, whole


def _state_like(model):
    like, _ = model.init_params(abstract=True)
    return {"params": like, "opt": adamw().init(like)}


def test_a_2x2_checkpoint_restores_whole_and_at_1x2(runs):
    """The chunked checkpoint the four ranks wrote restores whole (1 x 1)
    and as each rank's pieces of a (1 x 2) plan, bit for bit the state the
    ranks held; a leaf sharded over both axes has four chunks, one over
    ``model`` alone two."""
    io = runs[0]
    model, want = _saved_state(io)
    with open(os.path.join(io, "ckpt", "step_0000000001", "manifest.json")) as f:
        entries = json.load(f)["entries"]
    assert len(entries["params/blocks/attn/wq"]["chunks"]) == 4
    assert len(entries["opt/mu/blocks/mlp/wi_gate"]["chunks"]) == 4
    assert "chunks" not in entries["params/blocks/ln1/scale"]
    like = _state_like(model)
    whole, meta = restore(os.path.join(io, "ckpt"), like)
    assert meta["step"] == 1 and whole["opt"].step == 1
    trees = {"params": whole["params"], "mu": whole["opt"].mu, "nu": whole["opt"].nu}
    for key, arr in want.items():
        name, path = key.split("/", 1)
        np.testing.assert_array_equal(_flat(trees[name])[path].numpy(), arr)
    plan = build_sharding_plan(model, adamw(), mesh=SH.ProcessMesh(torch.device("cpu"),
                                                                   (1, 2)),
                               global_rows=ROWS, seq_len=SEQ)
    layouts = {"params": plan.params, "opt": plan.opt}
    lays = dict(SH.iter_layouts(plan.params))
    for coord in range(2):
        mine, _ = restore(os.path.join(io, "ckpt"), like, layouts=layouts, coord=coord)
        got = {"params": mine["params"], "mu": mine["opt"].mu, "nu": mine["opt"].nu}
        for key, arr in want.items():
            name, path = key.split("/", 1)
            np.testing.assert_array_equal(_flat(got[name])[path].numpy(),
                                          lays[path].local(torch.from_numpy(arr), coord))


def test_the_reference_restores_the_2x2_checkpoint(runs):
    io = runs[0]
    model, want = _saved_state(io)
    like = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                                  model.init_params(abstract=True)[0])
    jlike = {"params": like, "opt": JOptState(step=jnp.int32(0), mu=like, nu=like)}
    tree, meta = JM.restore(os.path.join(io, "ckpt"), jlike, step=1)
    assert meta["step"] == 1 and int(tree["opt"].step) == 1
    trees = {"params": tree["params"], "mu": tree["opt"].mu, "nu": tree["opt"].nu}
    for key, arr in want.items():
        name, path = key.split("/", 1)
        np.testing.assert_array_equal(np.asarray(_flat(trees[name])[path]), arr)
