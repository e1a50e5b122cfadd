"""Training of the MoE, encoder-decoder and vision-language families in the
port against the JAX package, on their smoke configs (float32, CPU).

* MoE (qwen3-moe-30b-a3b, dbrx-132b), on the JAX batcher's batches for
  ``launch/train.py``'s demo fleet: ``Model.forward`` logits and the summed
  router aux loss; ``value_and_grad`` in ``f32`` (and on qwen3's in
  ``int8-fused``), the router's gradient among the leaves; the aux loss's
  own gradient, which reaches the router; a 6-step AdamW + goyal
  trajectory of ``make_train_step`` against ``jit(make_train_step)``, and
  ``Session.run`` against the same jitted loop.  The JAX fused MoE layer
  runs its Pallas kernels in interpret mode, as tests/test_torch_moe.py
  runs them.
* whisper-medium and qwen2-vl-7b: 3 steps of ``make_train_step`` with
  ``frames`` / ``patch_embeds`` in the batch against
  ``jit(make_train_step)``, and step-1 gradients leaf by leaf.  The VLM runs
  with labels over its text only (the loss cuts the ``[patches | text]``
  logits) and with labels over every position (the layout of
  ``repro/configs/shapes.py:59-72``).
* ``remat`` on and off give the same gradients (MoE and encdec).

One numpy parameter tree goes to both packages.  No reference test is
leaned on (the JAX ``Session.run`` fails under the installed jax, so the
port's session is held to the reference's jitted step and batcher, as
tests/test_torch_train.py does).

Tolerances (float32 on both sides; XLA's CPU transcendentals and
reductions differ from PyTorch's in the last bit):
* MoE logits: atol 5e-5.  They reach ~35, whose f32 ulp is 3.8e-6, and an
  ulp of difference in the final hidden state reaches every logit through
  the head (measured 1.8e-5 on qwen3's, 1.2e-5 on dbrx's); aux rtol 1e-6;
* losses, aux and grad norms along the f32 trajectories: rtol 1e-5;
  ``int8-fused`` losses rtol 1e-4 and gradients atol 2e-3: a K/V rounding
  flip at a tie moves an attention output by one quantization step of a
  row (tests/test_torch_train.py's tolerances);
* f32 gradients leaf by leaf: atol 1e-4, rtol 1e-3, as tests/test_torch_train.py;
  the aux loss's own gradients (up to ~1e-2): atol 1e-5, rtol 1e-3;
* weights after the side-input steps: atol 1e-5, the key biases aside
  (their gradient is rounding noise, which AdamW scales to +-lr);
* remat on vs off: the recompute runs the same float32 operations in the
  same order on the CPU, so the gradients are held bit for bit.
"""
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
from repro_torch.api import FleetSpec, Session, SessionConfig
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, goyal_schedule
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.storage import DataConfig
from repro_torch.train import steps as S
from tests.test_torch_families import numpy_params
from tests.test_torch_train import _demo, _flat, _shards, jax_pallas

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

MOE_ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
# int8-fused changes only the attention, which both MoE archs share: one
# arch keeps the file's JAX compiles few
INT8_ARCHS = ("qwen3-moe-30b-a3b",)
SEQ, STEPS, SIDE_STEPS = 16, 6, 3
EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def moe_numpy_params(arch, seed=0):
    """``numpy_params`` with the expert weights (L, E, d_in, d_out) drawn
    over their own fan-in, d_in, rather than over the expert axis."""
    tree = numpy_params(arch, seed)
    rng = np.random.default_rng(seed + 1)
    moe = tree["blocks"]["moe"]
    for name in EXPERT_LEAVES:
        shape = moe[name].shape
        moe[name] = (rng.standard_normal(shape) / np.sqrt(shape[2])).astype(np.float32)
    return tree


def _carry(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree), params_from_jax(np_tree, "cpu")


@pytest.fixture(scope="module")
def weights():
    out = {arch: moe_numpy_params(arch) for arch in MOE_ARCHS}
    out.update({arch: numpy_params(arch) for arch in ("whisper-medium", "qwen2-vl-7b")})
    return out


def _assert_grads_close(grads, jgrads, atol, rtol=1e-3):
    """Leaf by leaf, in the JAX pytree order (dict keys sorted)."""
    got = sorted(_flat(grads).items())
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for (name, g), w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=rtol, err_msg=name)


def _np_batch(cfg, rows=4, seq=SEQ, seed=7, side=None, n_patch=4):
    """tokens / labels / loss_mask (one padded row, as the Stannis layout),
    plus ``side``: ``"frames"`` (whisper's n_frames), ``"text"`` (the VLM's
    ``n_patch`` patches, labels over the text) or ``"all"`` (labels over
    patches and text, shapes.py's layout: tokens seq - n_patch long)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (rows, seq + 1)).astype(np.int32)
    mask = np.ones((rows, seq), np.float32)
    mask[-1] = 0.0
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}
    if side == "frames":
        b["frames"] = rng.standard_normal((rows, cfg.n_frames, cfg.d_model)).astype(np.float32)
    elif side in ("text", "all"):
        b["patch_embeds"] = rng.standard_normal((rows, n_patch, cfg.d_model)).astype(np.float32)
        if side == "all":
            b["tokens"] = b["tokens"][:, n_patch:]
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _models(arch, prec="f32", **kw):
    return (jax_get_model(jax_smoke_config(arch).with_(train_precision=prec, **kw)),
            get_model(smoke_config(arch).with_(train_precision=prec, **kw)))


# ---------------------------------------------------------------------------
# MoE: the reference, one jitted function a (arch, precision)
# ---------------------------------------------------------------------------


def _moe_session_batches(arch):
    """The JAX batcher's first STEPS batches for ``launch/train.py``'s demo
    fleet (60 rows, 24 valid) and the valid-row count the schedule reads."""
    cfg = jax_smoke_config(arch)
    spec = _demo(JFleetSpec)
    js = JSession(model=jax_get_model(cfg), optimizer=jax_adamw(), fleet=spec,
                  data=JDataConfig(vocab=cfg.vocab, seq_len=SEQ, seed=0),
                  config=JSessionConfig(total_steps=STEPS), shards=_shards(spec))
    valid = js.tune().schedule.valid_rows
    batches = []
    for _ in range(STEPS):
        b = js.dataset.next_batch()
        batches.append({k: b[k] for k in ("tokens", "labels", "loss_mask")})
    return batches, valid


@pytest.fixture(scope="module")
def moe_reference(weights):
    """Per MoE arch: the metrics of ``jit(make_train_step)`` (AdamW, the
    Session's goyal schedule) over the batcher's first STEPS batches, from
    one jit that also returns, on each batch, the forward's logits and aux,
    ``value_and_grad(loss_fn)`` and the aux loss's own gradient (XLA shares
    the forward between the parts, so the jit costs about one compile;
    those of the first batch are kept), all in f32; and for INT8_ARCHS
    ``value_and_grad(loss_fn)`` in int8-fused on the first batch."""
    out = {}
    with jax_pallas():
        for arch in MOE_ARCHS:
            batches, valid = _moe_session_batches(arch)
            jm = jax_get_model(jax_smoke_config(arch))
            opt = jax_adamw()
            step = JS.make_train_step(jm, opt, jax_goyal(1e-3, valid, base_batch=256,
                                                         warmup_steps=20, total_steps=STEPS))

            def vag(model, p, bt):
                return jax.value_and_grad(lambda q: JS.loss_fn(model, q, bt), has_aux=True)(p)

            def first(p, s, bt, jm=jm, step=step):
                return (step(p, s, bt), jm.forward(p, bt["tokens"]), vag(jm, p, bt),
                        jax.grad(lambda q: jm.forward(q, bt["tokens"])[1])(p))

            params = jax.tree_util.tree_map(jnp.asarray, weights[arch])
            jfirst = jax.jit(first)        # reused for every step: one compile
            p, state, metrics = params, opt.init(params), []
            for i, b in enumerate(batches):
                (p, state, m), *parts = jfirst(p, state, _jax_batch(b))
                metrics.append(m)
                if i == 0:
                    fwd, f32, aux_grads = parts
            out[arch] = dict(batches=batches, fwd=fwd, aux_grads=aux_grads, vag={"f32": f32},
                             metrics=[{k: float(v) for k, v in m.items()} for m in metrics])
            if arch in INT8_ARCHS:
                jm8 = jax_get_model(jax_smoke_config(arch).with_(train_precision="int8-fused"))
                out[arch]["vag"]["int8-fused"] = jax.jit(lambda p, bt: vag(jm8, p, bt))(
                    params, _jax_batch(batches[0]))
    return out


# ---------------------------------------------------------------------------
# MoE: forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_logits_and_aux_match_jax(arch, weights, moe_reference):
    want, want_aux = moe_reference[arch]["fwd"]
    model = get_model(smoke_config(arch))
    tokens = moe_reference[arch]["batches"][0]["tokens"]
    with torch.no_grad():
        got, aux = model.forward(params_from_jax(weights[arch], "cpu"), torch.from_numpy(tokens))
    assert got.shape == (60, SEQ, model.cfg.vocab) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0.0)
    # one Switch loss per layer, each >= 1 (equality only at perfect balance)
    assert float(aux) >= model.cfg.n_layers
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


# (loss rtol, gradient atol), as tests/test_torch_train.py
LOSS_GRAD_TOL = {"f32": (1e-5, 1e-4), "int8-fused": (1e-4, 2e-3)}


@pytest.mark.parametrize("arch,prec", [(a, "f32") for a in MOE_ARCHS]
                         + [(a, "int8-fused") for a in INT8_ARCHS])
def test_moe_loss_and_grads_match_jax(arch, prec, weights, moe_reference):
    (jtotal, jparts), jgrads = moe_reference[arch]["vag"][prec]
    model = get_model(smoke_config(arch).with_(train_precision=prec))
    b = _torch_batch(moe_reference[arch]["batches"][0])
    (total, parts), grads = S.value_and_grad(model, params_from_jax(weights[arch], "cpu"), b)
    rtol, atol = LOSS_GRAD_TOL[prec]
    np.testing.assert_allclose(float(total), float(jtotal), rtol=rtol)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]), rtol=rtol)
    # the total carries the router loss at the default weight 0.01
    np.testing.assert_allclose(float(total), float(parts["loss"]) + 0.01 * float(parts["aux"]),
                               rtol=1e-6)
    _assert_grads_close(grads, jgrads, atol)
    assert float(grads["blocks"]["moe"]["router"].abs().max()) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_loss_reaches_the_router_gradient(arch, weights, moe_reference):
    """The aux loss's own gradient, leaf by leaf, equals the reference's, and
    the router's part is what ``aux_weight`` adds to the router gradient."""
    params = params_from_jax(weights[arch], "cpu")
    model = get_model(smoke_config(arch))
    b = _torch_batch(moe_reference[arch]["batches"][0])
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    _, aux = model.forward(live, b["tokens"])
    # the head and the final norm do not reach aux: their gradient is 0
    grads = iter(torch.autograd.grad(aux, tree_leaves(live), allow_unused=True))
    got = tree_map(lambda t: next(grads), live)
    got = tree_map(lambda t, g: torch.zeros_like(t) if g is None else g, live, got)
    _assert_grads_close(got, moe_reference[arch]["aux_grads"], atol=1e-5)
    router = {}
    for w in (0.0, 1.0):
        _, g = S.value_and_grad(model, params, b, aux_weight=w)
        router[w] = g["blocks"]["moe"]["router"]
    aux_router = got["blocks"]["moe"]["router"]
    assert float(aux_router.abs().max()) > 0.0
    torch.testing.assert_close(router[1.0] - router[0.0], aux_router, atol=1e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# MoE: 6-step trajectories through make_train_step and Session.run
# ---------------------------------------------------------------------------


def _assert_metrics_close(got, want, rtol=1e-5):
    for key in ("loss", "aux", "total", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), want[key], rtol=rtol, err_msg=key)
    assert float(got["lr"]) == want["lr"] and float(got["tokens"]) == want["tokens"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_trajectory_matches_jax(arch, weights, moe_reference):
    ref = moe_reference[arch]
    model = get_model(smoke_config(arch))
    sched = goyal_schedule(1e-3, 24, base_batch=256, warmup_steps=20, total_steps=STEPS)
    opt = adamw()
    step = S.make_train_step(model, opt, sched)
    params = params_from_jax(weights[arch], "cpu")
    state = opt.init(params)
    for b, w in zip(ref["batches"], ref["metrics"]):
        params, state, m = step(params, state, _torch_batch(b))
        _assert_metrics_close(m, w)
        assert float(m["tokens"]) == 24 * SEQ
    assert state.step == STEPS


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_session_run_matches_jax_loop(arch, weights, moe_reference):
    """``Session.run`` trains the MoE on the batches and schedule of the JAX
    loop above; each step's history entry carries the router's aux."""
    cfg = smoke_config(arch)
    spec = _demo(FleetSpec)
    session = Session(model=get_model(cfg), optimizer=adamw(), fleet=spec,
                      data=DataConfig(vocab=cfg.vocab, seq_len=SEQ, seed=0),
                      config=SessionConfig(total_steps=STEPS), shards=_shards(spec),
                      device="cpu")
    report = session.run(params_from_jax(weights[arch], "cpu"))
    assert report.steps_run == STEPS and session.compile_count == 1
    for h, w in zip(report.history, moe_reference[arch]["metrics"]):
        _assert_metrics_close(h, w)
        assert h["aux"] >= cfg.n_layers


# ---------------------------------------------------------------------------
# encoder-decoder and vision-language: make_train_step with side inputs
# ---------------------------------------------------------------------------

# (arch, side input): whisper's frames; the VLM's patches with labels over
# its text (the loss cuts the logits) or over every position
SIDE_CASES = [("whisper-medium", "frames"), ("qwen2-vl-7b", "text"), ("qwen2-vl-7b", "all")]


@pytest.mark.parametrize("arch,side", SIDE_CASES, ids=["whisper", "vlm-text", "vlm-all"])
def test_side_input_train_steps_match_jax(arch, side, weights):
    """Step 1's loss and gradients leaf by leaf, then SIDE_STEPS steps'
    metrics and the weights after them, against one jit of the reference's
    train step that also returns its ``value_and_grad`` (XLA shares the
    two, so it costs one compile)."""
    jm, model = _models(arch)
    sched = goyal_schedule(1e-3, 3, base_batch=256, warmup_steps=20, total_steps=SIDE_STEPS)
    jsched = jax_goyal(1e-3, 3, base_batch=256, warmup_steps=20, total_steps=SIDE_STEPS)
    jopt, opt = jax_adamw(), adamw()
    jparams, params = _carry(weights[arch])
    jstate, state = jopt.init(jparams), opt.init(params)
    jstep = JS.make_train_step(jm, jopt, jsched)
    both = jax.jit(lambda p, s, bt: (jstep(p, s, bt), jax.value_and_grad(
        lambda q: JS.loss_fn(jm, q, bt), has_aux=True)(p)))
    step = S.make_train_step(model, opt, sched)
    for i in range(SIDE_STEPS):
        b = _np_batch(model.cfg, side=side, seed=10 + i)
        if i == 0:
            (total, parts), grads = S.value_and_grad(model, params, _torch_batch(b))
        (jparams, jstate, jm_), ((jtotal, jparts), jgrads) = both(jparams, jstate, _jax_batch(b))
        if i == 0:
            np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
            assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
            assert float(parts["tokens"]) == 3 * SEQ
            _assert_grads_close(grads, jgrads, atol=1e-4)
            if side == "frames":
                # the tied embedding takes the gradient of the lookup and of the head
                assert float(grads["embedding"]["table"].abs().max()) > 0.0
        params, state, m = step(params, state, _torch_batch(b))
        _assert_metrics_close(m, {k: float(v) for k, v in jm_.items()})
    # the weights after the last step, but the key biases: their gradient is
    # zero in exact arithmetic (a key bias moves every logit of a query row
    # by the same amount, which the softmax cancels), and AdamW turns the
    # rounding noise left in it into steps of +-lr
    for (name, got), want in zip(sorted(_flat(params).items()),
                                 jax.tree_util.tree_leaves(jparams)):
        if not name.endswith("/bk"):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,side", [("qwen3-moe-30b-a3b", None), ("whisper-medium", "frames")],
                         ids=["moe", "encdec"])
def test_remat_leaves_gradients_unchanged(arch, side, weights):
    params = params_from_jax(weights[arch], "cpu")
    cfg = smoke_config(arch)
    b = _torch_batch(_np_batch(cfg, side=side))
    out = {}
    for remat in (True, False):
        (total, _), grads = S.value_and_grad(get_model(cfg.with_(remat=remat)), params, b)
        out[remat] = (float(total), _flat(grads))
    assert out[True][0] == out[False][0]
    for name, g in out[True][1].items():
        assert torch.equal(g, out[False][1][name]), name
