"""The port's serving slice end to end against the JAX package:
``ServeSession.generate`` greedy tokens on ``smoke_config("deepseek-7b")``
(batch 2, prompt 13, 6 new tokens), native and int8 KV cache, with the JAX
weights carried across.  The JAX side runs its Pallas kernels in interpret
mode.  Greedy tokens are compared exactly; sampled streams are held to
reproducibility only (``torch.Generator`` never draws ``jax.random``'s bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ServeSession as JaxServeSession
from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro_torch.api.serving import ServeSession
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as serve_driver
from repro_torch.models.api import get_model
from repro_torch.serve.sampling import SamplingParams

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

B, P, N_NEW = 2, 13, 6


@pytest.fixture(scope="module")
def weights():
    jparams, _ = jax_get_model(jax_smoke_config("deepseek-7b")).init_params(
        key=jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _prompt():
    return np.random.default_rng(1).integers(0, 256, (B, P)).astype(np.int32)


@pytest.mark.parametrize("kv_cache_dtype", ["native", "int8"])
def test_greedy_generate_tokens_match_jax(weights, monkeypatch, kv_cache_dtype):
    monkeypatch.setattr(JL.FLAGS, "use_pallas", True)
    monkeypatch.setattr(JL.FLAGS, "pallas_interpret", True)
    jparams, tparams = weights
    jm = jax_get_model(jax_smoke_config("deepseek-7b").with_(kv_cache_dtype=kv_cache_dtype))
    tm = get_model(smoke_config("deepseek-7b").with_(kv_cache_dtype=kv_cache_dtype))
    want = JaxServeSession(model=jm, params=jparams).generate(
        jnp.asarray(_prompt()), max_new_tokens=N_NEW).tokens
    got = ServeSession(model=tm, params=tparams, device="cpu").generate(
        torch.from_numpy(_prompt()), max_new_tokens=N_NEW)
    assert tuple(got.tokens.shape) == (B, 1 + N_NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want))
    assert got.decode_tok_s > 0 and got.prefill_time > 0


def test_sampled_generate_reproduces_itself(weights):
    _, tparams = weights
    model = get_model(smoke_config("deepseek-7b"))
    serve = ServeSession(model=model, params=tparams, device="cpu")
    sp = SamplingParams(temperature=0.9, top_k=16, seed=7)
    prompt = torch.from_numpy(_prompt())
    a = serve.generate(prompt, max_new_tokens=4, sampling=sp).tokens
    b = serve.generate(prompt, max_new_tokens=4, sampling=sp).tokens
    c = serve.generate(prompt, max_new_tokens=4,
                       sampling=SamplingParams(temperature=0.9, top_k=16, seed=8)).tokens
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert tuple(a.shape) == (B, 5) and ((a >= 0) & (a < 256)).all()


def test_driver_runs_on_cpu(capsys):
    rc = serve_driver.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                            "--tokens", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "sample token ids" in out
