"""The port's cluster gradient transport against the JAX package's.

``repro_torch.core.topology``'s ``ProcessMap`` / ``TransportSpec`` /
``ClusterSpec``, ``repro_torch.launch.transport`` (codec, star and ring
wires, reducer) and the bucket layout of ``repro_torch.train.steps`` are
held to ``repro.core.topology``, ``repro.launch.transport`` and
``repro.train.steps`` on the same inputs: the same validation errors and
values, byte-equal int8 payloads (the reference's ``quantize_flat`` runs its
Pallas kernel in interpret mode here, the port its plain quantizer), equal
residuals and top-k selections, the same bucket groups, and byte-equal
reduced vectors on every topology x compression spec of
``tests/test_transport.py``.  Threads stand in for worker processes, as in
the reference's tests; the multi-process runs are
``tests/test_torch_cluster.py``'s.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import topology as JT
from repro.launch import cluster as JC
from repro.launch import transport as JX
from repro.models.api import get_model as jax_get_model
from repro.train import steps as JS
from repro_torch.configs import smoke_config
from repro_torch.core.topology import ClusterSpec, ProcessMap, TransportSpec
from repro_torch.launch.cluster import SyncClient, SyncServer
from repro_torch.launch.transport import (
    GradCodec, GradReducer, RingTransport, StarTransport, SyncPeerLost, build_wire_transport,
)
from repro_torch.models.api import get_model
from repro_torch.optim import sgd_momentum
from repro_torch.optim.optimizers import tree_map
from repro_torch.train.steps import (
    flatten_buckets, make_apply_step, make_partial_grad_step, make_train_step, plan_buckets,
    tree_leaves_sorted, unflatten_buckets,
)

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


BAD_TRANSPORT = [dict(compression="zstd"), dict(topology="mesh"), dict(topk_ratio=0.0),
                 dict(topk_ratio=1.5), dict(buckets=0), dict(chunk=0), dict(timeout=0.0)]


@pytest.mark.parametrize("kw", BAD_TRANSPORT, ids=lambda kw: "-".join(map(str, kw.items())))
def test_transport_spec_rejects_as_the_reference(kw):
    with pytest.raises(ValueError) as want:
        JT.TransportSpec(**kw)
    with pytest.raises(ValueError) as got:
        TransportSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides", [{}, {"topology": "star", "timeout": 7.0},
                                       {"compression": "topk", "buckets": 3}])
def test_transport_spec_values_equal_the_reference(overrides):
    assert TransportSpec().to_dict() == JT.TransportSpec().to_dict()
    assert (TransportSpec.production(**overrides).to_dict()
            == JT.TransportSpec.production(**overrides).to_dict())
    # ClusterSpec takes the kwargs-dict form (the CLI / JSON path)
    got = ClusterSpec(processes=2, transport=TransportSpec.production(**overrides).to_dict())
    want = JT.ClusterSpec(processes=2,
                          transport=JT.TransportSpec.production(**overrides).to_dict())
    assert got.transport.to_dict() == want.transport.to_dict()
    for field in ("processes", "local_devices", "sync_port",
                  "membership_dir", "heartbeat_interval"):
        assert getattr(got, field) == getattr(want, field)


def test_cluster_spec_validation():
    for bad in (0, -1):
        with pytest.raises(ValueError) as want:
            JT.ClusterSpec(processes=bad)
        with pytest.raises(ValueError) as got:
            ClusterSpec(processes=bad)
        assert str(got.value) == str(want.value)
    assert ClusterSpec(processes=2, local_devices=1).local_devices == 1
    with pytest.raises(NotImplementedError, match="item 19"):
        ClusterSpec(processes=2, local_devices=4)


@pytest.mark.parametrize("groups", range(1, 7))
def test_process_map_equals_the_reference(groups):
    workers = tuple(f"csd/{i}" for i in range(groups))
    for procs in range(1, groups + 1):
        got, want = ProcessMap(workers, procs), JT.ProcessMap(workers, procs)
        assert [got.process_of_group(g) for g in range(groups)] == \
            [want.process_of_group(g) for g in range(groups)]
        for p in range(procs):
            assert got.local_groups(p) == want.local_groups(p)
            assert got.local_workers(p) == want.local_workers(p)
            for max_local in (1, 5, 20):
                assert got.row_span(p, max_local) == want.row_span(p, max_local)
        assert [got.process_of(w) for w in workers] == [want.process_of(w) for w in workers]
    for procs in (0, groups + 1):
        with pytest.raises(ValueError) as w:
            JT.ProcessMap(workers, procs)
        with pytest.raises(ValueError) as g:
            ProcessMap(workers, procs)
        assert str(g.value) == str(w.value)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def _vectors(n, steps, seed):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(n).astype(np.float32) * 10.0 ** rng.integers(-4, 2)
           for _ in range(steps)]
    out[0][: min(n, 7)] = 0.0                  # a stretch of zeros (and a zero chunk at n < 8)
    return out


@pytest.mark.parametrize("n,chunk", [(4096, 512), (1000, 512), (1, 512), (3 * 512 + 7, 512),
                                     (777, 64)])
def test_int8_payloads_and_residuals_equal_the_reference(n, chunk):
    """Three steps of one bucket: the int8 bytes, the scales and the
    residual after each step equal the reference codec's (its
    ``quantize_flat`` in Pallas interpret mode, zero-padded ragged tail)."""
    spec = dict(compression="int8", chunk=chunk)
    got_codec, want_codec = GradCodec(TransportSpec(**spec)), JX.GradCodec(JT.TransportSpec(**spec))
    for step, vec in enumerate(_vectors(n, 3, seed=n)):
        got = got_codec.encode(0, torch.from_numpy(vec.copy()))
        want = want_codec.encode(0, vec)
        assert got["k"] == want["k"] == "int8" and got["n"] == want["n"] == n
        assert got["q"].dtype == want["q"].dtype and got["q"].shape == want["q"].shape
        assert got["q"].tobytes() == want["q"].tobytes(), f"step {step}: int8 bytes differ"
        assert got["s"].tobytes() == want["s"].tobytes(), f"step {step}: scales differ"
        assert GradCodec.nbytes(got) == JX.GradCodec.nbytes(want)
        np.testing.assert_array_equal(got_codec.decode(got), want_codec.decode(want))
        np.testing.assert_array_equal(got_codec._residual[0].numpy(), want_codec._residual[0])


def test_topk_payloads_and_residuals_equal_the_reference():
    spec = dict(compression="topk", topk_ratio=0.05)
    got_codec, want_codec = GradCodec(TransportSpec(**spec)), JX.GradCodec(JT.TransportSpec(**spec))
    for vec in _vectors(2000, 3, seed=3):
        got, want = got_codec.encode(1, torch.from_numpy(vec.copy())), want_codec.encode(1, vec)
        assert got["i"].tobytes() == want["i"].tobytes()
        assert got["v"].tobytes() == want["v"].tobytes()
        np.testing.assert_array_equal(got_codec._residual[1].numpy(), want_codec._residual[1])


@pytest.mark.parametrize("kw", [dict(compression="int8"), dict(compression="int8", chunk=64),
                                dict(compression="topk", topk_ratio=0.1), dict()],
                         ids=["int8", "int8-chunk64", "topk", "raw"])
def test_decode_sum_equals_the_decode_loop(kw):
    """``GradCodec.decode_sum`` (int8: in place, by row blocks) is the
    reference reducer's loop -- decode each payload, add in order -- bit
    for bit, over three payloads of a ragged length spanning several
    blocks."""
    codec = GradCodec(TransportSpec(**kw))
    n = (1 << 21) + 333
    payloads = [codec.encode(p, vec) for p, vec in enumerate(_vectors(n, 3, seed=5))]
    want = None
    for p in payloads:
        d = JX.GradCodec(JT.TransportSpec(**kw)).decode(p)
        want = d if want is None else want + d
    assert codec.decode_sum(payloads).tobytes() == want.tobytes()


def test_raw_payload_and_residual_reset():
    vec = np.arange(10, dtype=np.float32)
    codec = GradCodec(TransportSpec())
    payload = codec.encode(0, vec)
    assert payload["k"] == "raw" and payload["v"].tobytes() == vec.tobytes()
    assert GradCodec.nbytes(payload) == vec.nbytes
    codec = GradCodec(TransportSpec(compression="int8"))
    codec.encode(0, np.ones(100, np.float32))
    assert codec._residual[0].shape == (100,)
    codec.encode(0, np.ones(50, np.float32))     # elastic replan: a new size
    assert codec._residual[0].shape == (50,)


# ---------------------------------------------------------------------------
# bucket layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b", "rwkv6-7b"])
def test_plan_buckets_equal_the_reference_on_the_smoke_tree(arch):
    jabs, _ = jax_get_model(jax_smoke_config(arch)).init_params(abstract=True)
    pabs, _ = get_model(smoke_config(arch)).init_params(abstract=True, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves_sorted(pabs)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jabs)]
    for n in (1, 2, 3, 5, 99):
        assert plan_buckets(pabs, n) == JS.plan_buckets(jabs, n)


def test_plan_buckets_byte_weighted_and_clamped():
    leaves = {k: torch.zeros(100) for k in "dcba"}     # insertion order is not the order
    assert plan_buckets(leaves, 2) == ((0, 1), (2, 3))
    assert len(plan_buckets(leaves, 99)) == 4
    assert plan_buckets(leaves, 0) == (tuple(range(4)),)
    big = [torch.zeros(1000), torch.zeros(10), torch.zeros(10), torch.zeros(10)]
    assert plan_buckets(big, 2) == ((0,), (1, 2, 3))


def test_flatten_unflatten_round_trips_exactly():
    g = torch.Generator().manual_seed(0)
    tree = {"z": {"b": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                  "a": torch.randn(5, generator=g)},
            "a": torch.randn(2, 2, 2, generator=g)}
    groups = plan_buckets(tree, 2)
    vecs = flatten_buckets(tree, groups)
    assert all(v.dtype == torch.float32 for v in vecs)
    # the vectors lay leaves out in sorted-key order: a, z/a, z/b
    flat = torch.cat(vecs)
    assert torch.equal(flat[:8], tree["a"].reshape(-1))
    back = unflatten_buckets(tree, groups, vecs)
    assert list(back) == list(tree) and list(back["z"]) == list(tree["z"])
    for a, b in zip(tree_leaves_sorted(back), tree_leaves_sorted(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# sync rounds and the ring (threads as workers)
# ---------------------------------------------------------------------------


def _clients(server, n, timeout=10.0):
    return [SyncClient(server.address, pid, timeout=timeout) for pid in range(n)]


def _threads(n, fn, timeout=30):
    ts = [threading.Thread(target=fn, args=(p,)) for p in range(n)]
    [t.start() for t in ts]
    [t.join(timeout) for t in ts]


def test_sync_allgather_pid_order_and_tag_reuse():
    server = SyncServer(3)
    try:
        clients = _clients(server, 3)
        out = [None] * 3
        _threads(3, lambda p: out.__setitem__(p, clients[p].allgather("g", f"blob-{p}")))
        assert out[0] == out[1] == out[2] == ["blob-0", "blob-1", "blob-2"]
        for step in range(3):               # rounds retire, so a tag is reusable
            _threads(3, lambda p: out.__setitem__(
                p, clients[p].allreduce("grad", {"v": np.float32(p + step)})))
            assert out[0] == out[1] == out[2] == {"v": np.float32(3 * step + 3)}
        assert not server._rounds
    finally:
        server.close()


def test_sync_kv_and_silent_coordinator():
    server = SyncServer(1)
    try:
        (client,) = _clients(server, 1)
        assert client.get("addr") is None
        client.put("addr", [1, 2])
        assert client.get("addr") == [1, 2]
        assert client.get("addr") is None      # consumed exactly once
    finally:
        server.close()
    from multiprocessing import connection

    listener = connection.Listener(("127.0.0.1", 0), authkey=b"repro-cluster-sync")
    stop = threading.Event()

    def mute():
        conn = listener.accept()
        conn.recv()
        conn.send({"ok": True, "n": 2})
        stop.wait(10)
        conn.close()

    threading.Thread(target=mute, daemon=True).start()
    host, port = listener.address
    client = SyncClient(f"{host}:{port}", 0, timeout=0.3)
    with pytest.raises(SyncPeerLost, match="silent"):
        client.barrier("never")
    stop.set()
    listener.close()


def test_round_poisoned_after_peer_death():
    """A participant dying mid-round does NOT hang the survivors: once the
    coordinator marks it dead, the blocked join raises ``SyncPeerLost``."""
    server = SyncServer(2)
    try:
        client = _clients(server, 2)[0]
        err = []

        def go():
            try:
                client.allreduce("g", {"v": 1.0})
            except SyncPeerLost as e:
                err.append(e)

        t = threading.Thread(target=go)
        t.start()
        time.sleep(0.2)
        server.mark_dead(1)
        t.join(10)
        assert err and "lost" in str(err[0])
    finally:
        server.close()


def test_ring_allgather_large_blobs():
    """Blobs far beyond the socket buffer over three ring workers (the
    sender thread keeps the simultaneous forwards from deadlocking)."""
    n = 3
    server = SyncServer(n)
    big = np.arange(1 << 19, dtype=np.float32)
    results, errs = [None] * n, []

    def worker(pid):
        sync = SyncClient(server.address, pid, timeout=30.0)
        ring = None
        try:
            ring = RingTransport(sync, pid, n, timeout=30.0)
            small = [ring.allgather(f"r{r}", {"pid": pid, "r": r}) for r in range(2)]
            got = ring.allgather("big", big * pid)
            results[pid] = (small, [float(x.sum()) for x in got])
        except BaseException as e:     # pragma: no cover - diagnostics
            errs.append((pid, e))
        finally:
            if ring is not None:
                ring.close()
            sync.close()

    _threads(n, worker, timeout=60)
    server.close()
    assert not errs, errs
    expect = ([[{"pid": p, "r": r} for p in range(n)] for r in range(2)],
              [float((big * p).sum()) for p in range(n)])
    assert results[0] == results[1] == results[2] == expect


def test_build_wire_transport_selects_topology():
    assert build_wire_transport(TransportSpec(), None, 0, 4) is None
    assert build_wire_transport(TransportSpec(), object(), 0, 1) is None
    assert isinstance(build_wire_transport(TransportSpec(), object(), 0, 2), StarTransport)


# ---------------------------------------------------------------------------
# the reducer, against the reference's
# ---------------------------------------------------------------------------


def _reduce_workers(server_cls, client_cls, build, reducer_cls, n, spec, fn, timeout=20.0):
    server = server_cls(n)
    results, errs = [None] * n, []

    def worker(pid):
        sync = client_cls(server.address, pid, timeout=timeout)
        red = None
        try:
            red = reducer_cls(build(spec, sync, pid, n), spec, pid, n)
            results[pid] = fn(pid, red)
        except BaseException as e:     # pragma: no cover - diagnostics
            errs.append((pid, e))
        finally:
            if red is not None:
                red.close()
            sync.close()

    _threads(n, worker, timeout=90)
    server.close()
    assert not errs, errs
    return results


SPECS = [dict(), dict(compression="int8", buckets=2, overlap=True),
         dict(compression="int8", topology="ring", buckets=2, overlap=True),
         dict(compression="topk", topk_ratio=0.1, topology="ring")]


@pytest.mark.parametrize("kw", SPECS, ids=["star-none", "star-int8-overlap",
                                           "ring-int8-overlap", "ring-topk"])
def test_reducer_bytes_equal_the_reference(kw):
    """Three worker threads, four steps of two buckets (512 and 188
    elements) each: every replica receives byte-equal reduced vectors and
    summed extras, and they equal the reference reducer's on the same
    per-worker inputs."""
    rng = np.random.default_rng(7)
    grads = {pid: [rng.standard_normal(700).astype(np.float32) for _ in range(4)]
             for pid in range(3)}

    def fn(as_input):
        def run(pid, red):
            out = []
            for step in range(4):
                g = grads[pid][step]
                vecs, sums = red.reduce(f"step/{step}", [as_input(g[:512]), as_input(g[512:])],
                                        {"loss": np.float32(pid + step)})
                out.append((b"".join(np.asarray(v).tobytes() for v in vecs),
                            float(sums["loss"])))
            return out
        return run

    got = _reduce_workers(SyncServer, SyncClient, build_wire_transport, GradReducer, 3,
                          TransportSpec(**kw), fn(lambda a: torch.from_numpy(a.copy())))
    want = _reduce_workers(JC.SyncServer, JC.SyncClient, JX.build_wire_transport,
                           JX.GradReducer, 3, JT.TransportSpec(**kw), fn(lambda a: a))
    assert got[0] == got[1] == got[2]
    assert got[0] == want[0]
    assert got[0][0][1] == 0 + 1 + 2


def test_reducer_raises_sync_peer_lost_on_a_dead_peer():
    """Worker 1 never joins the round and is marked dead: worker 0's reduce
    raises ``SyncPeerLost`` instead of waiting out its timeout."""
    server = SyncServer(2)
    spec = TransportSpec(compression="int8", buckets=1, overlap=True, timeout=30.0)
    sync = SyncClient(server.address, 0, timeout=30.0)
    red = GradReducer(build_wire_transport(spec, sync, 0, 2), spec, 0, 2)
    err = []

    def go():
        try:
            red.reduce("step/0", [torch.ones(64)], None)
        except SyncPeerLost as e:
            err.append(e)

    t0 = time.perf_counter()
    t = threading.Thread(target=go)
    t.start()
    time.sleep(0.3)
    server.mark_dead(1)
    t.join(20)
    try:
        assert err and "lost" in str(err[0])
        assert time.perf_counter() - t0 < 10
    finally:
        red.close()
        sync.close()
        server.close()


def test_reducer_reports_wire_stats():
    spec = TransportSpec(compression="int8")

    def fn(pid, red):
        for step in range(3):
            red.reduce(f"s/{step}", [torch.ones(2048)], None)
        return red.stats.snapshot()

    stats = _reduce_workers(SyncServer, SyncClient, build_wire_transport, GradReducer, 2, spec,
                            fn)[0]
    assert stats["steps"] == 3
    assert stats["compression_ratio"] > 3.0
    assert stats["wire_bytes_per_step"] < stats["raw_bytes_per_step"] == 2048 * 4
    assert stats["wait_s_per_step"] >= 0.0


# ---------------------------------------------------------------------------
# the hostsync step halves, against the reference's
# ---------------------------------------------------------------------------


SLAB_ROWS, SLAB_SEQ = 4, 16


def _slabs(vocab, n_slabs=2, seed=11):
    """``n_slabs`` row slabs of one global batch; the last row of each slab
    is padding (mask 0), as in the Stannis group-major layout."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_slabs):
        toks = rng.integers(0, vocab, (SLAB_ROWS, SLAB_SEQ + 1)).astype(np.int32)
        mask = np.ones((SLAB_ROWS, SLAB_SEQ), np.float32)
        mask[-1] = 0.0
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask})
    return out


@pytest.fixture(scope="module")
def partial_reference():
    """Per arch: the carried weights and, on each of two slabs, the
    reference's ``jit(make_partial_grad_step)`` (grads, sums); the MoE
    layer runs its Pallas kernels in interpret mode."""
    import jax.numpy as jnp

    from repro_torch.interop import params_from_jax
    from tests.test_torch_families import numpy_params
    from tests.test_torch_train import jax_pallas
    from tests.test_torch_train_families import moe_numpy_params

    out = {}
    with jax_pallas():
        for arch in ("deepseek-7b", "qwen3-moe-30b-a3b"):
            np_tree = moe_numpy_params(arch) if "moe" in arch else numpy_params(arch)
            jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
            step = jax.jit(JS.make_partial_grad_step(jax_get_model(jax_smoke_config(arch))))
            slabs = _slabs(smoke_config(arch).vocab)
            parts = [step(jparams, {k: jnp.asarray(v) for k, v in b.items()}) for b in slabs]
            out[arch] = dict(params=params_from_jax(np_tree, "cpu"), slabs=slabs, parts=parts)
    return out


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b"])
def test_partial_grads_equal_the_reference(partial_reference, arch):
    """On each row slab: every gradient leaf to 1e-5 of the leaf's largest
    reference value (f32 on both sides; XLA's CPU reductions differ from
    PyTorch's in the last bits), the sums to rtol 1e-6; the MoE's
    ``auxden`` is non-zero."""
    ref = partial_reference[arch]
    step = make_partial_grad_step(get_model(smoke_config(arch)))
    for b, (jgrads, jsums) in zip(ref["slabs"], ref["parts"]):
        grads, sums = step(ref["params"], _tb(b))
        got = tree_leaves_sorted(grads)
        want = jax.tree_util.tree_leaves(jgrads)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
        for k in ("num", "den", "auxden"):
            np.testing.assert_allclose(float(sums[k]), float(jsums[k]), rtol=1e-6)
        if "moe" in arch:
            assert float(sums["auxden"]) > 0


def _summed(parts):
    """The pid-ordered sum of the slabs' (grads, sums)."""
    grads, sums = parts[0]
    for g, s in parts[1:]:
        grads = tree_map(lambda a, b: a + b, grads, g)
        sums = {k: sums[k] + s[k] for k in sums}
    return grads, sums


def test_summed_slabs_then_apply_equal_the_train_step(partial_reference):
    """Dense: the pid-ordered sum of two slabs' partial steps, then
    ``make_apply_step``, equals ``make_train_step`` on the whole batch (two
    steps): metrics and weights to rtol 1e-6 (f32 reassociation of the
    sums), the weights also to atol 1e-6 of each leaf's largest (a weight
    that lands near zero keeps the absolute error of its larger terms).  SGD with momentum, whose update is linear in the gradient:
    AdamW's first step maps a gradient to about +-lr whatever its size, so
    a gradient that is rounding noise (~1e-9) moves a weight by a whole lr
    whichever way the noise falls."""
    import copy

    ref = partial_reference["deepseek-7b"]
    model = get_model(smoke_config("deepseek-7b"))
    sched = lambda step: torch.tensor(1e-3 * (step + 1), dtype=torch.float32)  # noqa: E731
    whole = {k: np.concatenate([b[k] for b in ref["slabs"]]) for k in ref["slabs"][0]}
    opt = sgd_momentum()
    p_train = copy.deepcopy(ref["params"])
    p_apply = copy.deepcopy(ref["params"])
    s_train, s_apply = opt.init(p_train), opt.init(p_apply)
    train, apply = make_train_step(model, opt, sched), make_apply_step(opt, sched)
    partial = make_partial_grad_step(model)
    for _ in range(2):
        p_train, s_train, m_train = train(p_train, s_train, _tb(whole))
        grads, sums = _summed([partial(p_apply, _tb(b)) for b in ref["slabs"]])
        p_apply, s_apply, m_apply = apply(p_apply, s_apply, grads, sums)
        for k in ("loss", "aux", "total", "lr", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(m_apply[k]), float(m_train[k]), rtol=1e-6, err_msg=k)
        for a, b in zip(tree_leaves_sorted(p_apply), tree_leaves_sorted(p_train)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(b.abs().max()))


def test_moe_apply_aux_is_the_den_weighted_mean(partial_reference):
    """MoE under hostsync: the router aux the apply step reports is
    ``Σ_p den_p aux_p / Σ_p den_p`` (the reference's formula), and the
    port's sums equal the reference's summed slabs."""
    ref = partial_reference["qwen3-moe-30b-a3b"]
    model = get_model(smoke_config("qwen3-moe-30b-a3b"))
    parts = [make_partial_grad_step(model)(ref["params"], _tb(b)) for b in ref["slabs"]]
    grads, sums = _summed(parts)
    opt = sgd_momentum()
    _, _, m = make_apply_step(opt, lambda s: torch.tensor(0.0))(
        ref["params"], opt.init(ref["params"]), grads, sums)
    dens = [float(s["den"]) for _, s in parts]
    auxes = [float(s["auxden"]) / d for (_, s), d in zip(parts, dens)]
    want = sum(d * a for d, a in zip(dens, auxes)) / sum(dens)
    np.testing.assert_allclose(float(m["aux"]), want, rtol=1e-6)
    jsum = sum(float(js["auxden"]) for _, js in ref["parts"]) / sum(
        float(js["den"]) for _, js in ref["parts"])
    np.testing.assert_allclose(float(m["aux"]), jsum, rtol=1e-6)
