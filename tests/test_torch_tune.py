"""The port's measured tune, heterogeneous-batch helpers and batched
serving example against the JAX package:

* ``core.tuner.tune`` over ``measured_benchmark`` under a deterministic
  clock gives the reference's ``TuneResult``, and so does the train
  driver's :class:`MeasuredTune` (real train steps on the CPU, the clock
  advanced by a fixed time per batch) against the reference launcher's
  closure (``launch/train.py:139-163`` there) under the same clock;
* ``python -m repro_torch.launch.train --device cpu --measured-tune`` runs;
* the masked-union gradient equality of tests/test_hetero.py through the
  port's ``weighted_grad_union_equivalence`` (``torch.autograd``), and
  ``apply_row_mask`` / ``effective_batch_per_class`` equal the reference's;
* ``repro_torch.examples.serve_batched`` gives the reference example's
  greedy tokens (its prefill + jitted serve step) from the same weights.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.configs import smoke_config as jax_smoke_config
from repro.core import hetero as JH
from repro.core import tuner as JT
from repro.models.api import get_model as jax_get_model
from repro.train.steps import make_serve_step as jax_make_serve_step
from repro_torch.api import FleetSpec
from repro_torch.configs import smoke_config
from repro_torch.core import hetero as H
from repro_torch.core import tuner as T
from repro_torch.examples import serve_batched
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_driver
from repro_torch.models.api import get_model

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each
FLEET = dict(host_tput=80.0, csd_tput=10.0, host_max_batch=16, csd_max_batch=4,
             host_idle=100.0, csd_idle=1.5)


class Clock:
    """A perf_counter that moves only when a step says so."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def step(self, batch):
        # a fixed launch cost, rows below 6 nearly free, then linear
        self.now += 0.020 + 0.001 * batch + 0.004 * max(0, batch - 6)


@pytest.fixture
def clocks(monkeypatch):
    port, ref = Clock(), Clock()
    monkeypatch.setattr(T, "_time", types.SimpleNamespace(perf_counter=port.perf_counter))
    monkeypatch.setattr(JT, "_time", types.SimpleNamespace(perf_counter=ref.perf_counter))
    return port, ref


def _same(got, want):
    assert got.batches == want.batches and got.reference_class == want.reference_class
    assert got.margin == want.margin
    for name in want.batches:
        assert got.step_times[name] == pytest.approx(want.step_times[name], rel=1e-12)
        assert got.throughputs[name] == pytest.approx(want.throughputs[name], rel=1e-12)


@pytest.mark.parametrize("n_csds,slow", [(2, 8.0), (3, 3.0), (1, 1.5)])
def test_measured_tune_under_a_clock_matches_the_reference(clocks, n_csds, slow):
    """Each class's step advances the clock; the CSD's ``slow`` times the host's."""
    def fns(clock):
        return {"host": clock.step, "csd": lambda b: clock.step(b * slow)}

    port, ref = clocks
    got = T.tune(FleetSpec.demo(n_csds, **FLEET).build(), T.measured_benchmark(fns(port)))
    want = JT.tune(JFleetSpec.demo(n_csds, **FLEET).build(), JT.measured_benchmark(fns(ref)))
    _same(got, want)
    assert got.batches["csd"] >= 1 and got.batches["host"] > got.batches["csd"]


def test_driver_measured_tune_matches_the_reference_closure(clocks):
    """The driver's benchmark times the real train step (smoke config, CPU)
    at each batch; under the clock its TuneResult is the reference
    launcher's: the host's time scaled by the peak-throughput ratio."""
    port, ref = clocks
    steps = []

    class Timed(train_driver.MeasuredTune):
        def _run_at(self, batch):
            super()._run_at(batch)
            steps.append(batch)
            port.step(batch)

    fleet = FleetSpec.demo(1, **FLEET).build()
    bench = Timed(get_model(smoke_config("deepseek-7b")), "adamw", 8, fleet, "cpu")
    got = T.tune(fleet, bench)

    jfleet = JFleetSpec.demo(1, **FLEET).build()
    core = JT.measured_benchmark({"host": ref.step})

    def reference(name, batch):
        rel = jfleet.by_name("host").peak_throughput / jfleet.by_name(name).peak_throughput
        return core("host", batch) * rel

    _same(got, JT.tune(jfleet, reference))
    assert len(steps) == 4 * len(bench.timings)                # a warm-up and 3 repeats each
    assert [n for n, _, _ in bench.timings].count("csd") == 3   # batches 1, 2, 4
    assert bench._params is not None
    bench.release()
    assert bench._params is None


def test_train_driver_runs_the_measured_tune_on_cpu(capsys):
    assert train_driver.main(["--device", "cpu", "--measured-tune", "--steps", "2",
                              "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "measured csd batch 1:" in out and "measured host batch" in out
    assert "tuned batches: {'csd': " in out and "2 steps in" in out


# ---------------------------------------------------------------------------
# heterogeneous batches
# ---------------------------------------------------------------------------


def _toy_grad_fn(params, x, row_mask):
    """tests/test_hetero.py's loss: mean squared error with the global mask
    normalization (the trainer's masked_mean_loss), through torch.autograd."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    pred = x @ p["w"] + p["b"]
    per_row = torch.sum((pred - 1.0) ** 2, dim=-1)
    loss = torch.sum(per_row * row_mask) / torch.clamp(torch.sum(row_mask), min=1.0)
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _jax_toy_grad_fn(params, x, row_mask):
    def loss(p):
        pred = x @ p["w"] + p["b"]
        per_row = jnp.sum((pred - 1.0) ** 2, axis=-1)
        return jnp.sum(per_row * row_mask) / jnp.maximum(jnp.sum(row_mask), 1.0)

    return jax.grad(loss)(params)


@pytest.mark.parametrize("sizes,seed", [((3, 1), 0), ((7, 2, 5), 1), ((1, 1, 4, 6, 2), 2),
                                        ((4, 4), 3)])
def test_weighted_grad_equals_union_batch(sizes, seed):
    rng = np.random.default_rng(seed)
    d = 4
    w = rng.standard_normal((d, d)).astype(np.float32)
    xs = [rng.standard_normal((b, d)).astype(np.float32) for b in sizes]
    params = {"w": torch.from_numpy(w), "b": torch.zeros(d)}
    g_masked, g_union = H.weighted_grad_union_equivalence(
        _toy_grad_fn, params, [torch.from_numpy(x) for x in xs])
    jm, ju = JH.weighted_grad_union_equivalence(
        _jax_toy_grad_fn, {"w": jnp.asarray(w), "b": jnp.zeros(d)}, [jnp.asarray(x) for x in xs])
    for k in ("w", "b"):
        np.testing.assert_allclose(g_masked[k].numpy(), g_union[k].numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g_masked[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g_union[k].numpy(), np.asarray(ju[k]), rtol=1e-5, atol=1e-6)


def test_row_mask_and_effective_batch_match_the_reference():
    rng = np.random.default_rng(0)
    loss_mask = (rng.random((6, 5)) > 0.3).astype(np.float32)
    row_mask = np.array([1, 1, 0, 1, 0, 0], np.float32)
    np.testing.assert_array_equal(
        H.apply_row_mask(torch.from_numpy(loss_mask), torch.from_numpy(row_mask)).numpy(),
        np.asarray(JH.apply_row_mask(jnp.asarray(loss_mask), jnp.asarray(row_mask))))
    tuned, counts = {"host": 20, "csd": 2, "gpu": 7}, {"host": 1, "csd": 3, "gpu": 2}
    sched, labels = H.schedule_from_tune(tuned, counts)
    jsched, jlabels = JH.schedule_from_tune(tuned, counts)
    assert H.effective_batch_per_class(sched, labels) == \
        JH.effective_batch_per_class(jsched, jlabels) == {"csd": 6, "gpu": 14, "host": 20}


# ---------------------------------------------------------------------------
# the batched serving example
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-7b", "rwkv6-7b"])
def test_serve_batched_tokens_match_the_reference_example(arch):
    B, P, N = 2, 8, 6
    jm = jax_get_model(jax_smoke_config(arch))
    jparams, _ = jm.init_params(key=jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(0, jm.cfg.vocab, (B, P)).astype(np.int32)

    # the reference example's path: prefill, argmax, then the jitted serve step
    logits, cache = jm.prefill(jparams, jnp.asarray(prompt), P + N + 1)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    serve = jax.jit(jax_make_serve_step(jm))
    want = [tok]
    for t in range(N):
        tok, _, cache = serve(jparams, tok, cache, jnp.full((B,), P + t, jnp.int32))
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    model = get_model(smoke_config(arch))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got, prefill_s, decode_s = serve_batched.generate_batched(
        model, params, torch.from_numpy(prompt), N)
    assert got.dtype == torch.int32 and got.shape == (B, 1 + N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert prefill_s > 0 and decode_s > 0


def test_serve_batched_main_runs_every_family_on_cpu(capsys):
    for arch in ("qwen3-moe-30b-a3b", "recurrentgemma-2b", "whisper-medium", "qwen2-vl-7b"):
        tokens = serve_batched.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                                     "--prompt-len", "6", "--tokens", "3"])
        assert tokens.shape == (2, 4)
    assert capsys.readouterr().out.count("decoded 3 tokens x 2 seqs") == 4
