"""The port's serve-engine slice against the JAX package: the plain versions
of the paged decode kernels, the block allocator and scheduler copies, and
``ServeEngine`` on the smoke configs of every family it serves (dense, both
MoE, rwkv6, recurrentgemma), with JAX weights carried across by
``params_from_jax``.  Inputs are made with numpy and handed to both packages.
The JAX paged kernels run in interpret mode, as tests/test_kernels.py runs
them; the JAX engine runs as tests/test_serve_engine.py runs it.

Tolerances and why:
* paged decode ops: 2e-5 in float32 and 2e-2 in bfloat16, as
  tests/test_kernels.py holds the JAX kernels to their oracle (the same f32
  softmax summed in another order; bf16 rounds the output once);
* the paged kernel's plain version against the contiguous one on the
  gathered rows: bit-equal (the same function on the same rows);
* engines: greedy tokens identical; a prefix-cache hit, an interleaving and
  a masked decode step bit-identical to the run without them; sampled
  streams equal to the port's own (``torch.Generator`` never draws
  ``jax.random``'s bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.models.api import get_model as jax_get_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import hash_chain as jax_hash_chain
from repro_torch.api.serving import ServeSession
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as serve_driver
from repro_torch.models.api import Model, get_model
from repro_torch.serve import (
    BlockAllocator, EngineConfig, RequestMeta, SamplingParams, Scheduler, ServeEngine,
    hash_chain, run_load,
)
from repro_torch.serve.adapters import slot_slice
from repro_torch.serve.runner import StepRunner
from repro_torch.serve.sampling import request_generator
from tests._hypothesis_compat import given, settings, st

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

SMOKE = dict(max_slots=2, max_len=48, block_size=4, num_blocks=32,
             prefill_chunk=8, token_budget=16)
SMOKE_CONFIG = EngineConfig(**SMOKE)
N_NEW = 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(t):
    return jnp.asarray(np.asarray(t))


# ---------------------------------------------------------------------------
# paged decode attention: the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # B, pool_pages, page_size, pages_per_row, H, Hkv, D, window, dtype
    (2, 12, 16, 4, 4, 4, 64, None, "float32"),
    (3, 16, 8, 5, 8, 2, 64, None, "float32"),
    (2, 10, 16, 3, 4, 1, 32, 24, "float32"),
    (2, 8, 8, 4, 2, 2, 128, None, "bfloat16"),
]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _paged_inputs(case, seed=7):
    B, P, bs, NP, H, Hkv, D, window, dtype = case
    rng = np.random.default_rng(seed)
    q, kp, vp = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, 1, H, D), (P, bs, Hkv, D), (P, bs, Hkv, D)))
    tbl = rng.integers(0, P, (B, NP)).astype(np.int32)
    valid = rng.integers(1, NP * bs + 1, (B,)).astype(np.int32)
    return q, kp, vp, tbl, valid, window, dtype


@pytest.mark.parametrize("case", PAGED_CASES, ids=[str(c[:8]) for c in PAGED_CASES])
def test_paged_decode_attention_matches_jax(case):
    q, kp, vp, tbl, valid, window, dtype = _paged_inputs(case)
    want = jops.paged_decode_attention(
        *(_j(a).astype(dtype) for a in (q, kp, vp)), _j(tbl), _j(valid),
        window=window, interpret=True)
    got = ops.paged_decode_attention(
        *(_t(a).to(TDT[dtype]) for a in (q, kp, vp)), _t(tbl), _t(valid), window=window)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", PAGED_CASES, ids=[str(c[:8]) for c in PAGED_CASES])
def test_paged_decode_attention_ref_matches_jax_ref(case):
    q, kp, vp, tbl, valid, window, dtype = _paged_inputs(case, seed=8)
    want = JR.paged_decode_attention_ref(
        *(_j(a).astype(dtype) for a in (q, kp, vp)), _j(tbl), _j(valid), window=window)
    got = R.paged_decode_attention_ref(
        *(_t(a).to(TDT[dtype]) for a in (q, kp, vp)), _t(tbl), _t(valid), window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


INT8_PAGED_CASES = [
    # B, H, Hkv, D, n_pool, page, NP, window
    (3, 4, 4, 64, 16, 8, 4, None),     # MHA
    (2, 8, 2, 32, 12, 8, 5, None),     # GQA
    (2, 4, 2, 32, 10, 16, 3, 12),      # GQA + window
    (1, 2, 1, 16, 6, 8, 4, None),      # MQA
]


def _int8_pages(case, seed):
    B, H, Hkv, D, n_pool, page, NP, window = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in JR.quantize_int8_ref(
        jnp.asarray(rng.standard_normal((n_pool, page, Hkv, D)), jnp.float32)))
    vq, vs = (np.asarray(a) for a in JR.quantize_int8_ref(
        jnp.asarray(rng.standard_normal((n_pool, page, Hkv, D)), jnp.float32)))
    tbl = rng.permutation(n_pool)[: B * NP].reshape(B, NP).astype(np.int32)
    valid = (np.arange(B, dtype=np.int32) * 7 % (NP * page)) + 2
    return q, kq, ks, vq, vs, tbl, valid, window


@pytest.mark.parametrize("case", INT8_PAGED_CASES, ids=[str(c) for c in INT8_PAGED_CASES])
def test_paged_decode_attention_int8_matches_jax(case):
    q, kq, ks, vq, vs, tbl, valid, window = _int8_pages(case, 11)
    want = jops.paged_decode_attention_int8(
        *(_j(a) for a in (q, kq, ks, vq, vs, tbl, valid)), window=window, interpret=True)
    want_ref = JR.paged_decode_attention_int8_ref(
        *(_j(a) for a in (q, kq, ks, vq, vs, tbl, valid)), window=window)
    args = tuple(_t(a) for a in (q, kq, ks, vq, vs, tbl, valid))
    got = ops.paged_decode_attention_int8(*args, window=window)
    got_ref = R.paged_decode_attention_int8_ref(*args, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_ref.numpy(), np.asarray(want_ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_paged_shared_prefix_pages_match_contiguous(kv):
    """Rows sharing pool pages (a cached prefix) == the contiguous decode op
    on each row's gathered cache, and == the JAX paged kernel."""
    B, P, bs, NP, H, Hkv, D = 3, 8, 8, 4, 4, 2, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((P, bs, Hkv, D)).astype(np.float32) for _ in range(2))
    tbl = np.asarray([[0, 1, 2, 3], [0, 1, 4, 5], [0, 1, 6, 7]], np.int32)
    valid = np.asarray([NP * bs, 25, 17], np.int32)
    tq, ttbl, tvalid = _t(q), _t(tbl), _t(valid)
    if kv == "native":
        got = ops.paged_decode_attention(tq, _t(kp), _t(vp), ttbl, tvalid)
        dense = ops.decode_attention(tq, R.gather_pages(_t(kp), ttbl),
                                     R.gather_pages(_t(vp), ttbl), tvalid)
        want = jops.paged_decode_attention(_j(q), _j(kp), _j(vp), _j(tbl), _j(valid),
                                           interpret=True)
    else:
        (kq, ks), (vq, vs) = (R.quantize_int8_ref(_t(a)) for a in (kp, vp))
        got = ops.paged_decode_attention_int8(tq, kq, ks, vq, vs, ttbl, tvalid)
        dense = ops.decode_attention_int8(
            tq, *(R.gather_pages(a, ttbl) for a in (kq, ks, vq, vs)), tvalid)
        want = jops.paged_decode_attention_int8(
            *(_j(a) for a in (q, kq, ks, vq, vs, tbl, valid)), interpret=True)
    assert torch.equal(got, dense)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_paged_rows_past_valid_len_are_never_read():
    """Table entries of pages past valid_len may be anything; a row with
    valid_len 0 gives 0."""
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((2, 1, 2, 16)).astype(np.float32))
    kp, vp = (_t(rng.standard_normal((4, 8, 2, 16)).astype(np.float32)) for _ in range(2))
    tbl = torch.tensor([[2, 1, 0], [3, 0, 0]], dtype=torch.int32)
    valid = torch.tensor([11, 0], dtype=torch.int32)
    out = ops.paged_decode_attention(q, kp, vp, tbl, valid)
    junk = tbl.clone()
    junk[0, 2] = 3
    assert torch.equal(out, ops.paged_decode_attention(q, kp, vp, junk, valid))
    assert torch.equal(out[1], torch.zeros_like(out[1]))


@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
def test_paged_kernel_wrappers_take_cuda_tensors_only(int8):
    """The launch wrappers never fall back: CPU tensors raise before any launch."""
    q = torch.zeros(1, 1, 2, 32)
    pages = torch.zeros(2, 8, 2, 32, dtype=torch.int8 if int8 else torch.float32)
    scales = torch.ones(2, 8, 2, 1)
    tbl, valid = torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if int8:
            DA.paged_decode_attention_int8(q, pages, scales, pages, scales, tbl, valid)
        else:
            DA.paged_decode_attention(q, pages, pages, tbl, valid)


# ---------------------------------------------------------------------------
# BlockAllocator and Scheduler (the copies), as tests/test_serve_engine.py
# ---------------------------------------------------------------------------


def test_allocator_alloc_free_cycle():
    a = BlockAllocator(4, 8)
    bids = [a.allocate() for _ in range(4)]
    assert sorted(bids) == [0, 1, 2, 3]
    assert a.allocate() is None
    for b in bids:
        a.free(b)
    assert a.num_free == 4
    assert a.allocate() is not None


def test_allocator_refcount_and_lookup():
    a = BlockAllocator(4, 8)
    bid = a.allocate(h=123)
    assert a.refcount(bid) == 1
    hit = a.lookup(123)
    assert hit == bid and a.refcount(bid) == 2
    a.decref(bid)
    a.decref(bid)
    assert a.refcount(bid) == 0 and a.contains(123)
    assert a.lookup(123) == bid and a.refcount(bid) == 1


def test_allocator_lru_eviction():
    a = BlockAllocator(2, 8)
    b0, b1 = a.allocate(h=10), a.allocate(h=11)
    a.decref(b0)
    a.decref(b1)
    assert a.allocate(h=12) == b0
    assert not a.contains(10) and a.contains(11) and a.contains(12)
    assert a.stats.evictions == 1


def test_allocator_referenced_blocks_never_evicted():
    a = BlockAllocator(2, 8)
    a.allocate(h=10)
    b1 = a.allocate(h=11)
    a.decref(b1)
    assert a.allocate(h=12) == b1
    assert a.allocate(h=13) is None
    assert a.contains(10)


def test_allocator_error_paths():
    a = BlockAllocator(2, 8)
    with pytest.raises(ValueError):
        a.decref(0)
    bid = a.allocate(h=5)
    with pytest.raises(ValueError):
        a.allocate(h=5)
    a.incref(bid)
    a.decref(bid)
    assert a.refcount(bid) == 1
    with pytest.raises(ValueError):
        BlockAllocator(0, 8)


def test_hash_chain_full_blocks_only_and_equal_to_the_reference():
    assert hash_chain([1, 2, 3], 4) == []
    c1 = hash_chain([1, 2, 3, 4], 4)
    c2 = hash_chain([1, 2, 3, 4, 5, 6, 7, 8], 4)
    assert len(c1) == 1 and len(c2) == 2 and c2[0] == c1[0] and c2[1] != c1[0]
    assert hash_chain([9, 2, 3, 4, 5, 6, 7, 8], 4)[1] != c2[1]
    toks = np.random.default_rng(0).integers(0, 102400, 70).tolist()
    for bs in (4, 8, 16):
        assert hash_chain(toks, bs) == jax_hash_chain(toks, bs)


def _drive(max_slots, token_budget, prefill_chunk, reqs):
    """Run the scheduler to completion, checking its invariants each step."""
    sched = Scheduler(max_slots=max_slots, token_budget=token_budget,
                      prefill_chunk=prefill_chunk)
    for i, (plen, mnt) in enumerate(reqs):
        sched.add(RequestMeta(request_id=i, prompt_len=plen, max_new_tokens=mnt))
    finish, admitted_order = {}, []
    for step in range(10_000):
        if not sched.has_work():
            break
        admitted_order.extend(sched.admit())
        s = sched.schedule()
        assert s.total_tokens <= token_budget
        slots = [r.slot for r in sched.requests.values() if r.slot is not None]
        assert len(slots) == len(set(slots))
        assert all(0 <= sl < max_slots for sl in slots)
        for w in s.prefill:
            sched.note_prefilled(w)
        for rid in s.decode:
            sched.note_decoded(rid)
        for rid in list(s.decode) + [w.request_id for w in s.prefill if w.last]:
            if sched.is_done(rid) and rid not in finish:
                finish[rid] = step
                sched.finish(rid)
    else:
        raise AssertionError("scheduler did not drain (starvation)")
    assert admitted_order == sorted(admitted_order)
    assert len(finish) == len(reqs)
    return finish


def test_scheduler_basic_drain():
    assert set(_drive(2, 16, 8, [(10, 4), (3, 2), (20, 1)])) == {0, 1, 2}


def test_scheduler_decode_prioritized_over_prefill():
    sched = Scheduler(max_slots=2, token_budget=8, prefill_chunk=8)
    sched.add(RequestMeta(request_id=0, prompt_len=4, max_new_tokens=4))
    sched.admit()
    sched.note_prefilled(sched.schedule().prefill[0])
    sched.add(RequestMeta(request_id=1, prompt_len=32, max_new_tokens=1))
    sched.admit()
    s = sched.schedule()
    assert s.decode == (0,)
    assert s.prefill and s.prefill[0].request_id == 1
    assert s.prefill[0].end - s.prefill[0].start == 7


def test_scheduler_rejects_bad_settings():
    with pytest.raises(ValueError):
        Scheduler(max_slots=2, token_budget=4, prefill_chunk=8)
    with pytest.raises(ValueError):
        Scheduler(max_slots=0, token_budget=8, prefill_chunk=8)


@settings(max_examples=60, deadline=None)
@given(
    max_slots=st.integers(1, 4),
    chunk=st.integers(1, 8),
    extra=st.integers(0, 8),
    reqs=st.lists(st.tuples(st.integers(1, 25), st.integers(1, 6)), min_size=1, max_size=12),
)
def test_scheduler_invariants_property(max_slots, chunk, extra, reqs):
    _drive(max_slots, chunk + extra, chunk, reqs)


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_invariants_on_seeded_mixes(seed):
    """The property above on request mixes drawn from a seed (runs without
    hypothesis)."""
    rng = np.random.default_rng(seed)
    chunk = int(rng.integers(1, 9))
    reqs = [(int(rng.integers(1, 26)), int(rng.integers(1, 7)))
            for _ in range(int(rng.integers(1, 13)))]
    _drive(int(rng.integers(1, 5)), chunk + int(rng.integers(0, 9)), chunk, reqs)


# ---------------------------------------------------------------------------
# ServeEngine against the JAX ServeEngine and the port's ServeSession
# ---------------------------------------------------------------------------

ENGINE_CASES = [
    ("deepseek-7b", "native"), ("deepseek-7b", "int8"),
    ("qwen3-moe-30b-a3b", "native"), ("qwen3-moe-30b-a3b", "int8"),
    ("dbrx-132b", "native"), ("dbrx-132b", "int8"),
    ("rwkv6-7b", "native"),
    ("recurrentgemma-2b", "native"), ("recurrentgemma-2b", "int8"),
]


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params on the CPU) per arch, from one JAX init."""
    memo = {}

    def get(arch):
        if arch not in memo:
            jparams, _ = jax_get_model(jax_smoke_config(arch)).init_params(
                key=jax.random.PRNGKey(0))
            memo[arch] = (jparams, params_from_jax(
                jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
        return memo[arch]

    return get


def _model(arch, kv="native"):
    return get_model(smoke_config(arch).with_(kv_cache_dtype=kv))


def _engine(arch, weights, kv="native", config=SMOKE_CONFIG):
    return ServeEngine(model=_model(arch, kv), params=weights(arch)[1], config=config,
                       device="cpu")


def _prompts(vocab, n=3, length=11, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (n, length)).astype(np.int32)


@pytest.fixture(scope="module")
def engine_tokens(weights):
    """Greedy tokens of the port engine per (arch, kv), run once."""
    memo = {}

    def get(arch, kv):
        if (arch, kv) not in memo:
            prompts = _prompts(smoke_config(arch).vocab)
            outs = _engine(arch, weights, kv).generate_batch(
                [p.tolist() for p in prompts], max_new_tokens=N_NEW + 1)
            assert all(o.finish_reason == "length" for o in outs)
            memo[arch, kv] = [o.tokens for o in outs]
        return memo[arch, kv]

    return get


@pytest.mark.parametrize("arch,kv", ENGINE_CASES)
def test_engine_greedy_tokens_match_jax_engine(arch, kv, weights, engine_tokens):
    cfg = jax_smoke_config(arch).with_(kv_cache_dtype=kv)
    prompts = _prompts(cfg.vocab)
    jeng = JaxServeEngine(model=jax_get_model(cfg), params=weights(arch)[0],
                          config=JaxEngineConfig(**SMOKE))
    want = [o.tokens for o in jeng.generate_batch([p.tolist() for p in prompts],
                                                  max_new_tokens=N_NEW + 1)]
    assert engine_tokens(arch, kv) == want


# The engine prefills by stepping decode_step, generate attention families by
# one batched prefill; greedy tokens agree on the smoke configs in float32,
# except qwen3-moe with an int8 cache, where the two routes' K/V round to
# different int8 rows and the tokens part: the JAX ServeEngine and the JAX
# ServeSession part there too (and the port's engine equals the JAX engine).
GENERATE_CASES = [c for c in ENGINE_CASES if c != ("qwen3-moe-30b-a3b", "int8")]


@pytest.mark.parametrize("arch,kv", GENERATE_CASES)
def test_engine_matches_one_shot_generate(arch, kv, weights, engine_tokens):
    session = ServeSession(model=_model(arch, kv), params=weights(arch)[1], device="cpu")
    oracle = session.generate(torch.from_numpy(_prompts(smoke_config(arch).vocab)),
                              max_new_tokens=N_NEW).tokens
    assert engine_tokens(arch, kv) == oracle.tolist()


@pytest.mark.parametrize("arch", ["deepseek-7b", "rwkv6-7b", "recurrentgemma-2b"])
def test_prefix_cache_hit_is_bit_identical(arch, weights):
    prompt = _prompts(smoke_config(arch).vocab, n=1, length=14, seed=4)[0].tolist()
    engine = _engine(arch, weights)
    cold = engine.generate_batch([prompt], max_new_tokens=6)[0]
    hits_before = engine.prefix_cache_stats.hit_blocks
    warm = engine.generate_batch([prompt], max_new_tokens=6)[0]
    assert engine.prefix_cache_stats.hit_blocks > hits_before
    assert warm.tokens == cold.tokens


def test_prefix_cache_shared_prefix_across_requests(weights):
    rng = np.random.default_rng(5)
    vocab = smoke_config("deepseek-7b").vocab
    prefix = rng.integers(0, vocab, size=12).tolist()
    a = prefix + rng.integers(0, vocab, size=4).tolist()
    b = prefix + rng.integers(0, vocab, size=4).tolist()
    engine = _engine("deepseek-7b", weights)
    shared = engine.generate_batch([a, b], max_new_tokens=4)
    assert engine.prefix_cache_stats.hit_blocks > 0
    solo = [_engine("deepseek-7b", weights).generate_batch([p], max_new_tokens=4)[0]
            for p in (a, b)]
    assert [o.tokens for o in shared] == [o.tokens for o in solo]


def test_prefix_blocks_land_in_the_pool_as_pages(weights):
    """After a request, its full prompt blocks sit in the pool in the
    (P, page_size, Hkv, D) layout the paged kernel reads: the paged op over
    the engine's own pages equals the contiguous op over the slot's rows."""
    engine = _engine("deepseek-7b", weights)
    prompt = _prompts(smoke_config("deepseek-7b").vocab, n=1, length=14, seed=6)[0].tolist()
    engine.submit(prompt, max_new_tokens=2)
    engine.step()                                  # prefill chunk 1 (8 tokens)
    engine.step()                                  # the rest: blocks published
    alloc, bs = engine.adapter.allocator, SMOKE_CONFIG.block_size
    table = torch.tensor([[alloc.lookup(h) for h in hash_chain(prompt, bs)]], dtype=torch.int32)
    n = table.shape[1] * bs                        # 12 of the 14 prompt rows
    cfg, cache, pool = smoke_config("deepseek-7b"), engine.adapter.cache, engine.adapter.pool
    q = torch.randn(1, 1, cfg.n_heads, cfg.resolved_head_dim(),
                    generator=torch.Generator().manual_seed(0))
    valid = torch.tensor([n], dtype=torch.int32)
    for layer in range(cfg.n_layers):
        paged = ops.paged_decode_attention(q, pool["k"][layer], pool["v"][layer], table, valid)
        rows = [cache[k][layer, 0:1, :n].contiguous() for k in ("k", "v")]
        assert torch.equal(paged, ops.decode_attention(q, *rows, valid))


def test_engine_eos_stops_early(weights):
    session = ServeSession(model=_model("deepseek-7b"), params=weights("deepseek-7b")[1],
                           device="cpu")
    prompt = _prompts(smoke_config("deepseek-7b").vocab, n=1, length=8, seed=3)
    ref = session.generate(torch.from_numpy(prompt), max_new_tokens=7).tokens[0].tolist()
    eos = ref[3]
    engine = _engine("deepseek-7b", weights,
                     config=dataclasses.replace(SMOKE_CONFIG, eos_token=eos))
    out = engine.generate_batch([prompt[0].tolist()], max_new_tokens=8)[0]
    assert out.finish_reason == "stop"
    assert out.tokens == ref[:ref.index(eos) + 1]


def test_streaming_events_in_order_and_done_once(weights):
    engine = _engine("deepseek-7b", weights)
    rids = [engine.submit([1 + i, 2, 3, 4, 5], max_new_tokens=4) for i in range(3)]
    seen = {r: [] for r in rids}
    while engine.has_work():
        for ev in engine.step():
            seen[ev.request_id].append(ev)
    for rid in rids:
        evs = seen[rid]
        assert [e.index for e in evs] == list(range(len(evs)))
        assert sum(e.done for e in evs) == 1 and evs[-1].done
        assert [e.token for e in evs] == engine.output(rid).tokens


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_admit_mid_decode_leaves_tokens_unchanged(arch, weights):
    """A request admitted while another decodes streams before the first
    finishes, and neither's tokens change against a solo run.  The second
    prompt (20 tokens) takes three prefill chunks while the first decodes, so
    its slot is mid-prefill in those decode steps."""
    rng = np.random.default_rng(0)
    vocab = smoke_config(arch).vocab
    p0, p1 = rng.integers(0, vocab, 6).tolist(), rng.integers(0, vocab, 20).tolist()
    solo = [_engine(arch, weights).generate_batch([p], max_new_tokens=8)[0].tokens
            for p in (p0, p1)]
    eng = _engine(arch, weights)
    r0 = eng.submit(p0, max_new_tokens=8)
    eng.step()
    r1 = eng.submit(p1, max_new_tokens=3)
    first_r1 = r0_done = None
    step = 1
    while eng.has_work():
        for ev in eng.step():
            if ev.request_id == r1 and first_r1 is None:
                first_r1 = step
            if ev.request_id == r0 and ev.done:
                r0_done = step
        step += 1
    assert first_r1 is not None and r0_done is not None and first_r1 < r0_done
    assert eng.output(r0).tokens == solo[0]
    assert eng.output(r1).tokens == solo[1][:3]


def _snapshot(tree, slot):
    out = {}
    for k, v in tree.items():
        out[k] = _snapshot(v, slot) if isinstance(v, dict) else v[:, slot].clone()
    return out


def _equal(a, b):
    return all(_equal(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k])
               for k in a)


@pytest.mark.parametrize("arch,kv,stale_pos", [
    ("deepseek-7b", "native", 5), ("deepseek-7b", "int8", 5),
    ("rwkv6-7b", "native", 5),
    ("recurrentgemma-2b", "native", 3),      # a row below the window of 8
    ("recurrentgemma-2b", "int8", 12),       # past the window: the whole window rolls
])
def test_decode_step_leaves_inactive_slots_bit_identical(arch, kv, stale_pos, weights):
    """The runner's masked decode step: the active slot changes, the inactive
    one (a stale position pointing into rows it holds) is kept bit for bit."""
    model = _model(arch, kv)
    params = weights(arch)[1]
    cache = model.init_cache(2, 24, device="cpu")
    runner = StepRunner(model)
    prompt = torch.from_numpy(_prompts(smoke_config(arch).vocab, n=2, length=16, seed=9))
    runner.extend(params, prompt, cache, 0)               # both slots hold 16 rows
    before = [_snapshot(cache, s) for s in (0, 1)]
    active = np.asarray([True, False])
    tok, _ = runner.decode(params, torch.tensor([[3], [4]], dtype=torch.int32), cache,
                           np.asarray([16, stale_pos], np.int32), active, [None, None],
                           np.zeros(2, np.float32), np.zeros(2, np.int32))
    assert int(tok[1]) == 0
    assert _equal(_snapshot(cache, 1), before[1])
    assert not _equal(_snapshot(cache, 0), before[0])


def test_slot_views_are_contiguous_per_layer(weights):
    """The kernels take a layer of a slot as is: ``a[l, s:s+1]`` of every
    cache leaf must be contiguous."""
    for arch, kv in ENGINE_CASES:
        sub = slot_slice(_model(arch, kv).init_cache(3, 16, device="cpu"), 1)
        for leaf in _leaves(sub):
            assert leaf[0].is_contiguous() and leaf.shape[1] == 1


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_int8_pool_holds_under_half_the_bytes(weights):
    native = _engine("deepseek-7b", weights)
    int8 = _engine("deepseek-7b", weights, "int8")
    size = lambda e: sum(t.numel() * t.element_size() for t in _leaves(e.adapter.pool))
    assert size(int8) < 0.5 * size(native)
    assert set(int8.adapter.pool) == {"k", "k_scale", "v", "v_scale"}


def test_submit_validation(weights):
    engine = _engine("deepseek-7b", weights)
    with pytest.raises(ValueError):
        engine.submit([], max_new_tokens=4)
    with pytest.raises(ValueError):
        engine.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError):
        engine.submit(list(range(60)), max_new_tokens=4)


def test_engine_config_validation():
    with pytest.raises(ValueError):
        EngineConfig(prefill_chunk=6, block_size=4)


def test_engine_params_must_live_on_its_device(weights):
    with pytest.raises((RuntimeError, ValueError)):     # no card, or params off the card
        ServeEngine(model=_model("deepseek-7b"), params=weights("deepseek-7b")[1],
                    config=SMOKE_CONFIG)              # device="cuda" by default


def test_unsupported_family_raises(weights):
    cfg = smoke_config("deepseek-7b").with_(family="encdec")
    model = Model(cfg=cfg, mod=_model("deepseek-7b").mod)
    with pytest.raises(NotImplementedError):
        ServeEngine(model=model, params=weights("deepseek-7b")[1], config=SMOKE_CONFIG,
                    device="cpu")


# ---------------------------------------------------------------------------
# sampled streams
# ---------------------------------------------------------------------------

SP = SamplingParams(temperature=0.9, top_k=16, seed=7)


@pytest.mark.parametrize("arch", ["deepseek-7b", "rwkv6-7b"])
def test_sampled_streams_reproduce_and_follow_the_seed(arch, weights):
    prompts = [p.tolist() for p in _prompts(smoke_config(arch).vocab, n=3, length=9, seed=2)]
    a = [o.tokens for o in _engine(arch, weights).generate_batch(prompts, max_new_tokens=5,
                                                                  sampling=SP)]
    b = [o.tokens for o in _engine(arch, weights).generate_batch(prompts, max_new_tokens=5,
                                                                  sampling=SP)]
    c = [o.tokens for o in _engine(arch, weights).generate_batch(
        prompts, max_new_tokens=5, sampling=dataclasses.replace(SP, seed=8))]
    assert a == b and a != c


def test_sampled_stream_does_not_depend_on_interleaving(weights):
    """Request 0 draws the same chain alone, beside other requests in two
    slots, and beside them in one slot (queued)."""
    vocab = smoke_config("deepseek-7b").vocab
    prompts = [p.tolist() for p in _prompts(vocab, n=4, length=10, seed=3)]
    alone = _engine("deepseek-7b", weights).generate_batch(
        prompts[:1], max_new_tokens=6, sampling=SP)[0].tokens
    mixed = _engine("deepseek-7b", weights)
    r0 = mixed.submit(prompts[0], max_new_tokens=6, sampling=SP)
    for p in prompts[1:]:
        mixed.submit(p, max_new_tokens=3)              # greedy neighbours
    mixed.run_to_completion()
    queued = _engine("deepseek-7b", weights,
                     config=dataclasses.replace(SMOKE_CONFIG, max_slots=1))
    outs = queued.generate_batch(prompts, max_new_tokens=6, sampling=SP)
    assert mixed.output(r0).tokens == alone == outs[0].tokens


def test_engine_sampled_matches_session_sampled(weights):
    """Row i of a sampled ``generate`` equals request i of the engine: both
    draw request i's generator once per token, in order."""
    session = ServeSession(model=_model("deepseek-7b"), params=weights("deepseek-7b")[1],
                           device="cpu")
    prompts = _prompts(smoke_config("deepseek-7b").vocab, n=2, length=9, seed=2)
    oracle = session.generate(torch.from_numpy(prompts), max_new_tokens=4, sampling=SP).tokens
    outs = _engine("deepseek-7b", weights).generate_batch(
        [p.tolist() for p in prompts], max_new_tokens=5, sampling=SP)
    assert [o.tokens for o in outs] == oracle.tolist()


def test_request_generators_are_seeded_by_seed_and_request():
    draw = lambda sp, rid: torch.rand(4, generator=request_generator(sp, rid, "cpu"))
    assert torch.equal(draw(SP, 0), draw(SP, 0))
    assert not torch.equal(draw(SP, 0), draw(SP, 1))
    assert not torch.equal(draw(SP, 0), draw(dataclasses.replace(SP, seed=8), 0))


# ---------------------------------------------------------------------------
# ServeSession hand-off, load generator and the driver
# ---------------------------------------------------------------------------


def test_generate_many_sizes_the_engine(weights):
    session = ServeSession(model=_model("deepseek-7b"), params=weights("deepseek-7b")[1],
                           device="cpu")
    prompts = [list(range(1, 1 + n)) for n in (5, 70, 9)]
    outs = session.generate_many(prompts, max_new_tokens=3)
    assert [len(o.tokens) for o in outs] == [3, 3, 3]
    eng = session.engine()
    assert eng.device == session.device and eng.config == EngineConfig()


def test_run_load_reports_prefix_hits(weights):
    engine = _engine("deepseek-7b", weights,
                     config=dataclasses.replace(SMOKE_CONFIG, max_slots=2))
    report = run_load(engine, n_requests=5, prompt_len=16, max_new_tokens=3,
                      shared_prefix_len=8, seed=0)
    assert report.n_requests == 5 and report.prefix_hit_rate > 0
    assert report.engine_steps == engine.steps > 0
    assert report.latency_p99_ms >= report.latency_p50_ms >= report.ttft_p50_ms > 0
    assert report.to_json()["family"] == "dense"


@pytest.mark.parametrize("mode", ["engine", "loadgen"])
def test_driver_engine_modes_run_on_cpu(mode, capsys):
    rc = serve_driver.main(["--mode", mode, "--device", "cpu", "--requests", "3",
                            "--prompt-len", "12", "--tokens", "3", "--slots", "2",
                            "--shared-prefix", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    if mode == "engine":
        assert out.count("[length]") == 3 and "device=cpu" in out
    else:
        assert '"n_requests": 3' in out and '"device": "cpu"' in out
