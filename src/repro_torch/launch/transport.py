"""Cluster gradient transport: compression, overlap pipelining, ring topology
(port of :mod:`repro.launch.transport`).

``hostsync`` cluster mode reduces per-process partial gradients every step.
This module is the transport behind
:class:`repro_torch.core.topology.TransportSpec`:

  * :class:`GradCodec` — per-bucket encode/decode with int8 per-chunk
    quantization or top-k sparsification, plus per-process error-feedback
    residuals.  A bucket on the card is encoded there: the int8 route runs
    the row quantizer kernel (``ops.quantize_int8``, ``csrc/quantize.cu``,
    the port of ``repro/kernels/quantize.py::_quantize_rows``) over the
    vector padded with zeros to ``(ceil(n/chunk), chunk)`` rows, and only
    the int8 bytes and the scales cross to the host; the residual stays on
    the card.  A CPU bucket runs the plain quantizer.  Either way the
    payload is byte-equal to the reference's ``quantize_flat``.
  * :class:`StarTransport` / :class:`RingTransport` — the wire: either the
    coordinator's :class:`~repro_torch.launch.cluster.SyncServer` (star) or
    a peer-to-peer allgather ring where workers listen on their own sockets
    and the coordinator is only used once, for rendezvous.
  * :class:`GradReducer` — the per-step driver: encode bucket *i*, hand it
    to a background thread (double-buffered) that gathers every peer's
    payload and decode-sums them in process-id order on the host (numpy
    f32, as the reference) while bucket *i+1* encodes.

**The determinism invariant**: in every topology x compression combination,
the reduced value is the f32 sum, in process-id order, of the *decoded*
per-worker payloads.  Each worker encodes its own contribution exactly once
and every worker decodes the identical bytes, so all replicas apply the
bit-identical update — compression changes *what* is summed, never who
computes the sum.  (star+none short-circuits through the server-side
pid-ordered tree-sum, which is the same sequence of f32 adds.)  The wire is
the reference's socket transport, not ``torch.distributed``: its
pid-ordered host sum is what keeps the replicas bit-identical.
"""
from __future__ import annotations

import queue
import threading
import time
from multiprocessing import connection
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import TransportSpec
from repro_torch.kernels import ops

_AUTHKEY = b"repro-cluster-sync"
# elements of an int8 decode computed at a time: the residual's on the card
# (bounds its temporaries at a full-width bucket to 64 MiB) and the peers'
# decode-sum on the host (a block of 4 MiB of float32 stays in cache)
_DECODE_ROWS_ELEMS = 1 << 24
_HOST_DECODE_ELEMS = 1 << 20


class SyncPeerLost(RuntimeError):
    """A peer process died mid-round; the cluster step cannot complete."""


def _tree_add(a, b):
    """Leafwise numpy sum of two trees of dicts, lists and tuples (None
    leaves stay None, as ``jax.tree_util.tree_map`` keeps them)."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return np.asarray(a) + np.asarray(b)


def _as_vec(vec) -> torch.Tensor:
    """A bucket as a flat float32 tensor where it lives (numpy and other
    array-likes become CPU tensors over the same memory where they can)."""
    if isinstance(vec, torch.Tensor):
        return vec.detach().reshape(-1).float()
    return torch.from_numpy(np.asarray(vec, dtype=np.float32).reshape(-1))


def dequantize_flat(q, scale, size: int) -> np.ndarray:
    """Numpy-side inverse of the int8 encode (peers decode on the host):
    ``(q.f32 * scale).reshape(-1)[:size]``, the reference's
    ``repro/kernels/quantize.py::dequantize_flat``."""
    q = np.asarray(q)
    scale = np.asarray(scale, dtype=np.float32)
    return (q.astype(np.float32) * scale).reshape(-1)[:size]


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


class GradCodec:
    """Encode/decode one worker's per-bucket gradient contribution.

    Lossy modes keep a per-bucket *error-feedback* residual: the difference
    between what this worker wanted to send and what its payload decodes to
    is added into the next step's contribution, so quantization bias and
    dropped top-k mass re-enter instead of accumulating as drift.  The
    residual lives where the bucket does (on the card for a card bucket) and
    is reset when a bucket changes size (elastic replan).
    """

    def __init__(self, spec: TransportSpec):
        self.spec = spec
        self._residual: Dict[int, torch.Tensor] = {}

    def encode(self, bucket: int, vec) -> Dict[str, Any]:
        vec = _as_vec(vec)
        mode = self.spec.compression
        if mode == "none":
            return {"k": "raw", "v": vec.cpu().numpy()}
        res = self._residual.pop(bucket, None)
        if res is not None and (res.shape != vec.shape or res.device != vec.device):
            res = None
        # y = vec + residual; a fresh residual adds 0.0, as the reference's zeros
        addend = 0.0 if res is None else res
        if mode == "int8":
            payload, residual = self._encode_int8(vec, addend)
        else:
            payload, residual = self._encode_topk(vec, addend)
        self._residual[bucket] = residual
        return payload

    def _encode_int8(self, vec: torch.Tensor, addend) -> Tuple[Dict[str, Any], torch.Tensor]:
        """The reference's ``quantize_flat`` (rows of ``chunk`` padded with
        zeros, noise 0.5) through ``ops.quantize_int8``; the residual
        ``y - decode(payload)`` is computed in place of y, a product then a
        difference as the reference's numpy decode does."""
        n, chunk = vec.numel(), self.spec.chunk
        rows = -(-n // chunk)
        ypad = torch.zeros(rows * chunk, dtype=torch.float32, device=vec.device)
        y = ypad[:n]
        torch.add(vec, addend, out=y)
        del addend
        mat = ypad.view(rows, chunk)
        q, scale = ops.quantize_int8(mat, 0.5)
        step = max(1, _DECODE_ROWS_ELEMS // chunk)
        for r0 in range(0, rows, step):
            mat[r0:r0 + step].sub_(q[r0:r0 + step].float() * scale[r0:r0 + step])
        payload = {"k": "int8", "q": q.cpu().numpy(), "s": scale.cpu().numpy(), "n": n}
        return payload, y

    def _encode_topk(self, vec: torch.Tensor, addend) -> Tuple[Dict[str, Any], torch.Tensor]:
        """The reference's selection on the host (numpy ``argpartition``,
        then the indices sorted); the residual where the bucket lives."""
        y = vec + addend
        yh = y.cpu().numpy()
        n = int(yh.shape[0])
        k = max(1, int(n * self.spec.topk_ratio))
        idx = np.argpartition(np.abs(yh), n - k)[n - k:]
        idx.sort()  # deterministic order (argpartition's tail is unordered)
        payload = {
            "k": "topk", "i": idx.astype(np.uint32),
            "v": yh[idx].astype(np.float32), "n": n,
        }
        return payload, y - torch.from_numpy(self.decode(payload)).to(y.device)

    def decode_sum(self, payloads: Sequence[Dict[str, Any]]) -> np.ndarray:
        """The f32 sum, in the order given (process-id order), of the
        decoded payloads: the reference's ``decode`` of each and ``+``.
        For int8 payloads the same float32 products and adds run in place,
        a block of rows at a time, so the host makes one pass over the sum
        and allocates no decoded copy of a payload."""
        if not all(p["k"] == "int8" for p in payloads):
            total = None
            for p in payloads:
                decoded = self.decode(p)
                total = decoded if total is None else total + decoded
            return total
        rows, chunk = payloads[0]["q"].shape
        total = np.empty((rows, chunk), np.float32)
        step = max(1, _HOST_DECODE_ELEMS // chunk)
        tmp = np.empty((min(rows, step), chunk), np.float32)
        for r0 in range(0, rows, step):
            out = total[r0:r0 + step]
            first, rest = payloads[0], payloads[1:]
            np.multiply(first["q"][r0:r0 + step], first["s"][r0:r0 + step], out=out)
            for p in rest:
                t = tmp[:out.shape[0]]
                np.multiply(p["q"][r0:r0 + step], p["s"][r0:r0 + step], out=t)
                np.add(out, t, out=out)
        return total.reshape(-1)[:payloads[0]["n"]]

    def decode(self, payload: Dict[str, Any]) -> np.ndarray:
        kind = payload["k"]
        if kind == "raw":
            return np.asarray(payload["v"], dtype=np.float32)
        if kind == "int8":
            return dequantize_flat(payload["q"], payload["s"], payload["n"])
        if kind == "topk":
            out = np.zeros(payload["n"], dtype=np.float32)
            out[np.asarray(payload["i"], dtype=np.int64)] = payload["v"]
            return out
        raise ValueError(f"unknown payload kind {kind!r}")

    @staticmethod
    def nbytes(payload: Dict[str, Any]) -> int:
        return sum(
            v.nbytes for v in payload.values() if isinstance(v, np.ndarray)
        )


# ---------------------------------------------------------------------------
# Wire layers
# ---------------------------------------------------------------------------


class StarTransport:
    """Coordinator-routed wire (the fallback topology).

    ``allgather`` collects every worker's blob pid-ordered through the
    :class:`~repro_torch.launch.cluster.SyncServer`; ``allreduce_tree`` is the
    wire-cheaper server-side tree-sum used by the uncompressed path.
    """

    topology = "star"

    def __init__(self, sync):
        self.sync = sync

    def allgather(self, tag: str, blob) -> List[Any]:
        return self.sync.allgather(tag, blob)

    def allreduce_tree(self, tag: str, tree):
        return self.sync.allreduce(tag, tree)

    def close(self) -> None:
        pass


class RingTransport:
    """Peer-to-peer allgather ring; the coordinator is rendezvous only.

    Every worker owns a listener socket and publishes its address through
    the coordinator kv store once at startup; worker *p* connects to
    ``(p+1) % n`` and accepts from ``(p-1) % n``.  An allgather is ``n-1``
    lockstep hops: forward the previous hop's blob right while receiving a
    new one from the left.  Sends run on a dedicated thread — with blobs
    larger than the socket buffer a synchronous send would deadlock the
    ring (everyone blocked sending, nobody receiving).
    """

    topology = "ring"

    def __init__(
        self,
        sync,
        process_id: int,
        n_processes: int,
        *,
        timeout: float = 120.0,
    ):
        self.pid = int(process_id)
        self.n = int(n_processes)
        self.timeout = float(timeout)
        self._send_err: Optional[BaseException] = None
        self._listener = connection.Listener(
            ("127.0.0.1", 0), authkey=_AUTHKEY
        )
        sync.put(f"ring/addr/{self.pid}", list(self._listener.address))
        # accept must already be in flight when we dial: Client() blocks in
        # the auth handshake until the peer accept()s, so connect-then-accept
        # would deadlock the whole ring (everyone dialing, nobody answering)
        accept_box: Dict[str, Any] = {}
        accept_thread = self._start_accept(accept_box)
        right_addr = self._await_kv(sync, f"ring/addr/{(self.pid + 1) % self.n}")
        self._right = connection.Client(tuple(right_addr), authkey=_AUTHKEY)
        self._left = self._join_accept(accept_thread, accept_box)
        self._sendq: "queue.Queue" = queue.Queue()
        self._sender = threading.Thread(
            target=self._send_loop, daemon=True, name=f"ring-send-p{self.pid}"
        )
        self._sender.start()
        sync.barrier("ring/up")

    def _await_kv(self, sync, tag: str):
        deadline = time.monotonic() + self.timeout
        while True:
            value = sync.get(tag)
            if value is not None:
                return value
            if time.monotonic() > deadline:
                raise SyncPeerLost(
                    f"ring rendezvous: {tag} never published "
                    f"within {self.timeout}s"
                )
            time.sleep(0.02)

    def _start_accept(self, box: Dict[str, Any]) -> threading.Thread:
        def accept():
            try:
                box["conn"] = self._listener.accept()
            except BaseException as exc:  # surfaces as the timeout below
                box["err"] = exc

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        return t

    def _join_accept(self, t: threading.Thread, box: Dict[str, Any]):
        t.join(self.timeout)
        if "conn" not in box:
            raise SyncPeerLost(
                f"ring: left neighbour of process {self.pid} did not "
                f"connect within {self.timeout}s ({box.get('err')})"
            )
        return box["conn"]

    def _send_loop(self):
        while True:
            item = self._sendq.get()
            if item is None:
                return
            try:
                self._right.send(item)
            except BaseException as exc:
                self._send_err = exc
                return

    def _post(self, item) -> None:
        if self._send_err is not None:
            raise SyncPeerLost(f"ring: send to right neighbour failed: "
                               f"{self._send_err}")
        self._sendq.put(item)

    def _recv(self):
        if self._send_err is not None:
            raise SyncPeerLost(f"ring: send to right neighbour failed: "
                               f"{self._send_err}")
        try:
            if not self._left.poll(self.timeout):
                raise SyncPeerLost(
                    f"ring: nothing from left neighbour of process "
                    f"{self.pid} within {self.timeout}s"
                )
            return self._left.recv()
        except (EOFError, OSError, ConnectionError) as exc:
            raise SyncPeerLost(f"ring: left neighbour hung up: {exc}") from exc

    def allgather(self, tag: str, blob) -> List[Any]:
        """All workers call this with the same ``tag`` in the same order."""
        out: List[Any] = [None] * self.n
        out[self.pid] = blob
        self._post((tag, self.pid, blob))
        for hop in range(self.n - 1):
            got_tag, origin, body = self._recv()
            if got_tag != tag:
                raise SyncPeerLost(
                    f"ring protocol skew: received round {got_tag!r} "
                    f"while gathering {tag!r}"
                )
            out[origin] = body
            if hop < self.n - 2:
                self._post((got_tag, origin, body))
        return out

    def close(self) -> None:
        # flush queued forwards before tearing down: neighbours may still
        # be mid-hop on data sitting in our send queue
        self._sendq.put(None)
        self._sender.join(timeout=5.0)
        for c in (self._right, self._left):
            try:
                c.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass


def build_wire_transport(
    spec: TransportSpec, sync, process_id: int, n_processes: int
):
    """The wire layer named by ``spec.topology`` (None when single-process)."""
    if sync is None or n_processes <= 1:
        return None
    if spec.topology == "ring":
        return RingTransport(
            sync, process_id, n_processes, timeout=spec.timeout
        )
    return StarTransport(sync)


# ---------------------------------------------------------------------------
# Reducer (the per-step driver)
# ---------------------------------------------------------------------------


class TransportStats:
    """Per-worker wire accounting, reported in the cluster result record.

    ``wait_s`` is the time ``reduce`` blocked on the gathers after its last
    encode (the wire wait the overlap did not hide)."""

    def __init__(self):
        self.steps = 0
        self.raw_bytes = 0
        self.wire_bytes = 0
        self.encode_s = 0.0
        self.wire_s = 0.0
        self.decode_s = 0.0
        self.wait_s = 0.0
        self.reduce_s = 0.0

    def snapshot(self) -> Dict[str, Any]:
        steps = max(1, self.steps)
        return {
            "steps": self.steps,
            "raw_bytes_per_step": self.raw_bytes // steps,
            "wire_bytes_per_step": self.wire_bytes // steps,
            "compression_ratio": round(
                self.raw_bytes / max(1, self.wire_bytes), 2
            ),
            "encode_s_per_step": round(self.encode_s / steps, 5),
            "wire_s_per_step": round(self.wire_s / steps, 5),
            "decode_s_per_step": round(self.decode_s / steps, 5),
            "wait_s_per_step": round(self.wait_s / steps, 5),
            "reduce_s_per_step": round(self.reduce_s / steps, 5),
        }


class _Future:
    __slots__ = ("_ev", "_val", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._val = None
        self._exc: Optional[BaseException] = None

    def set(self, value) -> None:
        self._val = value
        self._ev.set()

    def set_exc(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def result(self, timeout: float):
        if not self._ev.wait(timeout):
            raise SyncPeerLost(
                f"gradient reduction stalled for {timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        return self._val


class GradReducer:
    """Reduce per-bucket flat gradient vectors across all workers.

    ``reduce(tag, buckets, sums)`` returns the pid-ordered f32 sum of every
    worker's decoded contribution per bucket (host numpy vectors), plus the
    tree-summed ``sums`` (loss numerators/denominators, riding with bucket
    0).  A bucket is a float32 vector where it lives: a card tensor is
    encoded on the card (:class:`GradCodec`), and only its payload crosses
    to the host.  With
    ``spec.overlap`` the gather+decode of bucket *i* runs on a background
    thread while bucket *i+1* encodes on the caller's thread (queue bounded
    at 2 — double buffering, bounded memory).
    """

    def __init__(
        self,
        wire,
        spec: TransportSpec,
        process_id: int,
        n_processes: int,
    ):
        self.wire = wire
        self.spec = spec
        self.pid = int(process_id)
        self.n = int(n_processes)
        self.codec = GradCodec(spec)
        self.stats = TransportStats()
        self._q: Optional["queue.Queue"] = None
        if spec.overlap:
            self._q = queue.Queue(maxsize=2)
            self._worker = threading.Thread(
                target=self._drain, daemon=True,
                name=f"grad-reduce-p{self.pid}",
            )
            self._worker.start()

    # uncompressed star rounds can use the server-side tree-sum: one blob
    # up, the pid-ordered total back — same f32 add sequence, half the
    # client traffic of an allgather through the same socket
    def _server_side(self) -> bool:
        return (
            self.spec.compression == "none"
            and hasattr(self.wire, "allreduce_tree")
        )

    def _drain(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            self._run_job(*job)

    def _run_job(self, tag, bucket, payload, extra, fut):
        try:
            t0 = time.perf_counter()
            if self._server_side():
                vec, sums = self.wire.allreduce_tree(
                    tag, (payload["v"], extra)
                )
                self.stats.wire_s += time.perf_counter() - t0
                fut.set((np.asarray(vec, dtype=np.float32), sums))
                return
            gathered = self.wire.allgather(tag, (payload, extra))
            self.stats.wire_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            total = self.codec.decode_sum([p for p, _ in gathered])   # pid order
            sums_total = None
            for _, peer_extra in gathered:
                if peer_extra is not None:
                    sums_total = (
                        peer_extra if sums_total is None
                        else _tree_add(sums_total, peer_extra)
                    )
            self.stats.decode_s += time.perf_counter() - t0
            fut.set((total, sums_total))
        except BaseException as exc:
            fut.set_exc(exc)

    def reduce(
        self, tag: str, buckets: Sequence, sums
    ) -> Tuple[List[np.ndarray], Any]:
        t_start = time.perf_counter()
        futures: List[_Future] = []
        for b, vec in enumerate(buckets):
            t0 = time.perf_counter()
            vec = _as_vec(vec)
            payload = self.codec.encode(b, vec)
            self.stats.encode_s += time.perf_counter() - t0
            self.stats.raw_bytes += vec.numel() * vec.element_size()
            self.stats.wire_bytes += self.codec.nbytes(payload)
            fut = _Future()
            job = (f"{tag}/b{b}", b, payload, sums if b == 0 else None, fut)
            if self._q is not None:
                self._q.put(job)
            else:
                self._run_job(*job)
            futures.append(fut)
        t0 = time.perf_counter()
        outs = [f.result(self.spec.timeout + 5.0) for f in futures]
        self.stats.wait_s += time.perf_counter() - t0
        self.stats.steps += 1
        self.stats.reduce_s += time.perf_counter() - t_start
        return [o[0] for o in outs], outs[0][1]

    def close(self) -> None:
        if self._q is not None:
            self._q.put(None)
            self._worker.join(timeout=5.0)
        if self.wire is not None:
            self.wire.close()
