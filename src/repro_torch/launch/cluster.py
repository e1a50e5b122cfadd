"""Multi-process cluster execution (``spmd`` and ``hostsync``): per-worker
storage custody, one model replicated across processes (port of
:mod:`repro.launch.cluster`).

STANNIS's rack is a *cluster*: every computational storage device trains
against the data it physically holds, and the host only ever sees
aggregates.  This module is the process-level realization of that topology:

  * :class:`ClusterCoordinator` — launches N worker PROCESSES (fresh
    interpreters through ``subprocess``, each holding one torch device),
    serves the gradient/barrier :class:`SyncServer`, and collects
    per-process result records.
  * :class:`WorkerRuntime` — what each worker process runs: a
    :class:`~repro_torch.launch.mesh.ClusterContext` attached to a standard
    :class:`~repro_torch.api.Session`, a membership heartbeat
    (:class:`~repro_torch.api.membership.HeartbeatWriter`), and the training
    loop with the per-process data plane: THIS process provisions only its
    own dp-groups' storage devices and lands only its row slab on its
    device, receipted every step.

Execution strategy is ``ClusterContext.mode`` (``ClusterContext.detect``
picks it unless the spec names one):

  * ``spmd`` -- one ``torch.distributed`` group, a rank a process (NCCL for
    CUDA workers, ``gloo`` for CPU workers or, named, for workers that
    share a card), rendezvous at a file store in the coordinator's run
    directory: each rank computes the partial gradient over its row slab
    and ``dist.all_reduce`` sums gradients and the loss's numerator and
    denominator (:func:`repro_torch.train.steps.make_spmd_train_step`);
    under a plan that shards weights over ``data`` it is ZeRO-3, each rank
    holding its shards of the parameters and moments.
  * ``hostsync`` -- no process group: the partial gradients meet in a
    pid-ordered f32 sum over the socket transport
    (:mod:`repro_torch.launch.transport`), the paper's host aggregation;
    several CUDA processes may share one card.

Where the machine has a card a worker, worker ``p`` binds ``cuda:{p}``
before it builds its session; ``detect`` picks ``spmd`` only for workers so
bound whose plan shards nothing over ``model``.

Either way every process applies the identical update: numerically the
single-program step (dense models exactly; see
:func:`repro_torch.train.steps.make_partial_grad_step`).  The cluster's
mesh keeps ``model = 1``, as the reference's: tensor and expert
parallelism run on ``launch.mesh.make_host_mesh`` through
``train.steps.make_spmd_train_step(plan=)``; several devices a process are
the rest of the second half of ROADMAP item 19.

CLI (the worker entry the coordinator spawns, also usable by hand):

    PYTHONPATH=src python -m repro_torch.launch.cluster --worker \\
        --process-id 0 --num-processes 2 --sync 127.0.0.1:7802 \\
        --membership-dir /tmp/members \\
        --factory repro_torch.launch.cluster:demo_session_factory \\
        --factory-kwargs '{"steps": 6, "device": "cpu"}'
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing import AuthenticationError, connection
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.topology import ClusterSpec, TransportSpec
from repro_torch.distributed import zero
from repro_torch.roofline.collectives import collective_bytes
from repro_torch.launch.transport import (  # noqa: F401  (SyncPeerLost re-exported)
    SyncPeerLost, _tree_add, build_wire_transport,
)
from repro_torch.train.steps import tree_leaves_sorted

_AUTHKEY = b"repro-cluster-sync"


# ---------------------------------------------------------------------------
# Coordinator-side sync service + worker-side client
# ---------------------------------------------------------------------------


class SyncServer:
    """The coordinator's reduction/barrier service.

    One TCP listener; every worker connects once and issues blocking
    rounds: ``allreduce`` (tree-sum of numpy pytrees, accumulated in
    process-id order so every participant receives the bit-identical
    total — replicas stay synchronized without a broadcast),
    ``allgather`` (every participant receives the pid-ordered list of all
    payloads — the compressed transport decodes and sums client-side), and
    ``barrier``.  A participant dying mid-round poisons the round: the
    survivors get :class:`SyncPeerLost` instead of a silent hang.
    """

    def __init__(self, n_processes: int, port: Optional[int] = None):
        self.n = int(n_processes)
        # port 0 lets the OS pick a free one while the listener holds it.
        # The backlog must cover every worker dialing at once: the default (1)
        # drops simultaneous SYNs and the kernel's retransmission backoff
        # can stall a client past the rendezvous window on a loaded host
        self._listener = connection.Listener(
            ("127.0.0.1", port or 0), authkey=_AUTHKEY,
            backlog=max(16, self.n + 4),
        )
        self.port = self._listener.address[1]
        self._lock = threading.Condition()
        self._rounds: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._dead: set = set()
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._accepter = threading.Thread(target=self._accept, daemon=True)
        self._accepter.start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _accept(self):
        while not self._stop:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return
            t = threading.Thread(
                target=self._serve_one, args=(conn,), daemon=True
            )
            t.start()
            # reap finished handlers so long runs don't accumulate them
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_one(self, conn):
        pid = None
        try:
            hello = conn.recv()
            pid = int(hello["pid"])
            conn.send({"ok": True, "n": self.n})
            while True:
                msg = conn.recv()
                op, tag = msg["op"], msg["tag"]
                if op in ("allreduce", "allgather", "barrier"):
                    result = self._join_round(
                        op, tag, pid, msg.get("payload")
                    )
                    conn.send(result)
                elif op == "put":
                    with self._lock:
                        self._rounds[("kv", tag)] = {"value": msg["payload"]}
                        self._lock.notify_all()
                    conn.send({"ok": True})
                elif op == "get":
                    # retire on read: kv is single-consumer rendezvous
                    # state, and keeping every tag alive leaks memory
                    with self._lock:
                        slot = self._rounds.pop(("kv", tag), None)
                    conn.send({"ok": True, "value":
                               None if slot is None else slot["value"]})
                else:
                    conn.send({"error": f"unknown op {op!r}"})
        except (EOFError, OSError, ConnectionError):
            pass
        finally:
            if pid is not None:
                self.mark_dead(pid)
            try:
                conn.close()
            except OSError:
                pass

    def mark_dead(self, pid: int):
        """Poison every pending round that still waits on ``pid``."""
        with self._lock:
            self._dead.add(pid)
            for key, round_ in self._rounds.items():
                if key[0] == "kv" or round_.get("done"):
                    continue
                round_["error"] = f"process {pid} lost mid-round {key}"
                round_["done"] = True
            self._lock.notify_all()

    def _join_round(self, op: str, tag: str, pid: int, payload):
        key = (op, tag)
        parts = None
        with self._lock:
            round_ = self._rounds.setdefault(key, {"got": {}, "done": False})
            round_["got"][pid] = payload
            if self._dead and not round_["done"]:
                # a reduction over PARTIAL membership is silently wrong
                # training, never a degraded mode: any round touched after
                # a death fails loudly (mid-round ones are poisoned by
                # mark_dead; this covers rounds STARTED after it)
                round_["error"] = (
                    f"process(es) {sorted(self._dead)} lost; "
                    f"round {key} cannot complete"
                )
                round_["done"] = True
                self._lock.notify_all()
            complete = (
                not round_["done"]
                and not round_.get("summing")
                and set(range(self.n)) <= set(round_["got"])
            )
            if complete:
                if op == "allreduce":
                    # the tree-sum happens OUTSIDE the lock (below): on
                    # large grad payloads it would otherwise serialize
                    # every other connection's round for its duration
                    round_["summing"] = True
                    parts = [round_["got"][p] for p in sorted(round_["got"])]
                else:
                    if op == "allgather":
                        round_["result"] = [
                            round_["got"][p] for p in sorted(round_["got"])
                        ]
                    round_["done"] = True
                    self._lock.notify_all()
        if parts is not None:
            total = parts[0]
            for part in parts[1:]:  # pid order — bit-identical everywhere
                total = _tree_add(total, part)
            with self._lock:
                round_["result"] = total
                round_["done"] = True
                self._lock.notify_all()
        with self._lock:
            while not round_["done"]:
                self._lock.wait(timeout=0.5)
            resp = (
                {"error": round_["error"]} if round_.get("error")
                else {"ok": True, "result": round_.get("result")}
            )
            # last reader retires the round (grad payloads are large)
            round_["readers"] = round_.get("readers", 0) + 1
            if round_["readers"] >= len(round_["got"]):
                self._rounds.pop(key, None)
            return resp

    def close(self):
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass


class SyncClient:
    """Worker-side handle to the coordinator's :class:`SyncServer`.

    ``timeout`` bounds every round-trip: a coordinator that dies mid-round
    (or a round stalled on a hung peer) raises :class:`SyncPeerLost`
    instead of blocking the worker forever on a bare ``recv()``.
    """

    def __init__(self, address: str, process_id: int, *,
                 timeout: float = 120.0):
        host, port = address.rsplit(":", 1)
        self.process_id = int(process_id)
        self.timeout = float(timeout)
        self._conn = self._dial(host, int(port))
        self._lock = threading.Lock()
        self._conn.send({"pid": self.process_id})
        if not self._conn.poll(self.timeout):
            raise SyncPeerLost(
                f"coordinator never answered the handshake "
                f"within {self.timeout}s"
            )
        hello = self._conn.recv()
        if not hello.get("ok"):
            raise RuntimeError(f"sync handshake failed: {hello}")
        self.n_processes = int(hello["n"])

    def _dial(self, host: str, port: int):
        # Workers all dial at startup; on an oversubscribed host a connect
        # (or its auth challenge) can be refused or reset while the
        # coordinator's accept loop is starved, so retry under the timeout
        # instead of failing on the first attempt.
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                return connection.Client((host, port), authkey=_AUTHKEY)
            except (ConnectionError, OSError, AuthenticationError) as exc:
                if time.monotonic() > deadline:
                    raise SyncPeerLost(
                        f"could not reach coordinator at {host}:{port} "
                        f"within {self.timeout}s: {exc}"
                    ) from exc
                time.sleep(0.2)

    def _request(self, op: str, tag: str, payload=None):
        with self._lock:
            try:
                self._conn.send({"op": op, "tag": tag, "payload": payload})
                if not self._conn.poll(self.timeout):
                    raise SyncPeerLost(
                        f"coordinator silent for {self.timeout}s "
                        f"(op={op!r}, tag={tag!r})"
                    )
                resp = self._conn.recv()
            except (EOFError, ConnectionError, OSError) as exc:
                raise SyncPeerLost(
                    f"coordinator connection lost (op={op!r}, "
                    f"tag={tag!r}): {exc}"
                ) from exc
        if "error" in resp:
            raise SyncPeerLost(resp["error"])
        return resp.get("result") if op != "get" else resp.get("value")

    def allreduce(self, tag: str, tree):
        """Sum ``tree`` (numpy pytree) across all live processes."""
        return self._request("allreduce", tag, tree)

    def allgather(self, tag: str, payload) -> list:
        """Collect every process's payload, ordered by process id."""
        return self._request("allgather", tag, payload)

    def barrier(self, tag: str) -> None:
        self._request("barrier", tag)

    def put(self, tag: str, value) -> None:
        self._request("put", tag, value)

    def get(self, tag: str):
        return self._request("get", tag)

    def close(self):
        try:
            self._conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Worker runtime (runs INSIDE each worker process)
# ---------------------------------------------------------------------------


def _resolve_factory(spec: str) -> Callable:
    """``"module.path:function"`` -> the session factory callable."""
    mod, _, fn = spec.partition(":")
    if not fn:
        raise ValueError(
            f"factory must be 'module:function', got {spec!r}"
        )
    return getattr(importlib.import_module(mod), fn)


def _params_digest(params) -> str:
    """sha256 over the param leaves' bytes, leaves in the reference's order
    (dict keys sorted), so equal values give the reference's digest."""
    h = hashlib.sha256()
    for leaf in tree_leaves_sorted(params):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves_sorted(tree)) if tree else 0


@dataclasses.dataclass
class WorkerRuntime:
    """One worker process's lifecycle: sync client -> session -> train.

    Drives a completely standard :class:`~repro_torch.api.Session` — the
    ONLY cluster-specific acts are attaching the
    :class:`~repro_torch.launch.mesh.ClusterContext` and beating the
    membership heartbeat.  Everything else (local-only custody, span
    feeding, the hostsync compile, coordinated checkpoints) follows from the
    session's cluster mode.
    """

    process_id: int
    num_processes: int
    sync_address: Optional[str]        # SyncServer address (None if N == 1)
    membership_dir: Optional[str]
    factory: str
    factory_kwargs: Dict[str, Any]
    heartbeat_interval: float = 0.25
    transport: Optional[Dict[str, Any]] = None   # TransportSpec kwargs
    mode: Optional[str] = None         # "spmd" | "hostsync"; None: detect
    rendezvous: Optional[str] = None   # spmd process group init_method
    backend: Optional[str] = None      # spmd group backend; None: by device

    def run(self, resume_steps: int = 2) -> Dict[str, Any]:
        from repro_torch.launch.mesh import ClusterContext

        n = self.num_processes
        if 1 < n <= (torch.cuda.device_count() if torch.cuda.is_available() else 0):
            # a card a worker: the factory's "cuda" resolves to cuda:{rank}
            torch.cuda.set_device(self.process_id)
        tspec = TransportSpec(**(self.transport or {}))
        sync = (
            SyncClient(self.sync_address, self.process_id, timeout=tspec.timeout)
            if self.sync_address and n > 1 else None
        )
        wire, beat, owns_group, ctx = None, None, False, None
        try:
            session = _resolve_factory(self.factory)(**self.factory_kwargs)
            kw = dict(sync=sync, member=f"proc-{self.process_id}", transport_spec=tspec,
                      device=session.device, backend=self.backend)
            if self.mode is not None:
                ctx = ClusterContext(self.process_id, n, mode=self.mode, **kw)
            elif n > 1:
                ctx = ClusterContext.detect(self.process_id, n, plan=session.spmd_plan(n), **kw)
            else:
                # the degenerate one-process launch trains unattached, as the reference's
                ctx = ClusterContext(self.process_id, self.num_processes, **kw)
            if ctx.mode == "hostsync":
                wire = build_wire_transport(tspec, sync, self.process_id, self.num_processes)
                ctx.transport = wire
            else:
                owns_group = ctx.init_process_group(self.rendezvous, tspec.timeout)
            if self.num_processes > 1 or ctx.mode == "spmd":
                session.attach_cluster(ctx)

            tp = session.tune()
            pmap = session.process_map()
            local_workers = pmap.local_workers(self.process_id) if pmap else tp.group_workers
            if self.membership_dir:
                from repro_torch.api.membership import HeartbeatWriter

                beat = HeartbeatWriter(
                    self.membership_dir, ctx.member or f"proc-{self.process_id}",
                    local_workers, interval=self.heartbeat_interval,
                ).start()
            record = self._train(session, ctx, pmap, resume_steps=resume_steps)
        finally:
            if beat is not None:
                beat.stop()
            if ctx is not None and ctx.grad_reducer is not None:
                ctx.grad_reducer.close()      # also closes the wire
            elif wire is not None:
                wire.close()
            if sync is not None:
                sync.close()
            if owns_group:
                import torch.distributed as dist

                dist.destroy_process_group()
        return record

    def _train(self, session, ctx, pmap, *, resume_steps: int) -> Dict[str, Any]:
        from repro_torch.api.events import DriftDetected
        from repro_torch.kernels import ops

        manifest = session.place()
        plan = session.shard()
        dev = session.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        report = session.run()
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

        # -- the addressable-slice invariant, receipted on the LAST feed --
        receipt = session.devices.last_receipt
        local_ids = [dev.index or 0]
        addressable_only = receipt is not None and set(receipt.devices) <= set(local_ids)

        # -- drift re-tune must keep the compiled step (capacity pinned) --
        compiles_before = session.compile_count
        drift = session.apply(DriftDetected())
        session.compile()
        no_recompile = not drift.recompiled and session.compile_count == compiles_before

        # -- continue after the re-tune (resumes the coordinated checkpoint
        #    when one is configured: every process restores the same state) --
        resumed_losses: List[float] = []
        final_report = report
        if resume_steps > 0:
            report2 = session.run(
                report.params, opt_state=report.opt_state,
                steps=session.config.total_steps + resume_steps,
            )
            resumed_losses = [h["loss"] for h in report2.history]
            final_report = report2

        reducer = ctx.grad_reducer
        final_params = final_report.params
        opt = final_report.opt_state
        zero3 = session.zero3()
        if zero3 is not None:
            final_params = zero.gathered_tree(final_params, zero3[0],
                                              plan.mesh.get_group("data"))
        return {
            "process": self.process_id,
            "n_processes": self.num_processes,
            "mode": ctx.mode if session.cluster else "single",
            "backend": ctx.backend if ctx.mode == "spmd" else None,
            "world_size": self.num_processes,
            "mesh": str(plan.mesh),
            "plan": plan.describe(),
            "device": str(dev),
            "local_devices": len(local_ids),
            "losses": [h["loss"] for h in report.history],
            "step_times": [h["step_time"] for h in report.history],
            "resumed_losses": resumed_losses,
            # bit-identity probe: replicas must end every run with the
            # EXACT same parameters (compared across records by the rigs);
            # under ZeRO-3 the digest of the gathered parameters
            "param_digest": _params_digest(final_params),
            "zero3": zero3 is not None,
            # what this rank holds: its shards under ZeRO-3
            "param_bytes": _tree_bytes(final_report.params),
            "moment_bytes": _tree_bytes(opt.mu) + _tree_bytes(opt.nu),
            # the spmd step's collectives in its last step, and their wire
            # bytes a device by kind (the reference's ring accounting)
            "collective_ops": [list(op) for op in session.step_collectives],
            "collective_bytes": collective_bytes(session.step_collectives),
            "transport": None if reducer is None else {
                "topology": getattr(reducer.wire, "topology", "star"),
                "spec": dataclasses.asdict(reducer.spec),
                **reducer.stats.snapshot(),
            },
            # seconds of the cluster step's parts over both runs
            "step_split": dict(session.cluster_timing),
            "launches": launches,
            "peak_bytes": peak,
            # the process's peak resident host memory (Linux: KiB)
            "host_peak_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "compile_count": session.compile_count,
            "drift_no_recompile": bool(no_recompile),
            "local_workers": list(
                pmap.local_workers(self.process_id) if pmap
                else session.tune().group_workers
            ),
            "remote_workers": [d.worker for d in manifest.devices if d.backend == "remote"],
            "manifest_local": [d.worker for d in manifest.local_devices()],
            "addressable_only": bool(addressable_only),
            "receipt": None if receipt is None else {
                "rows_local": receipt.rows_local,
                "rows_global": receipt.rows_global,
                "bytes_put": receipt.bytes_put,
                "n_puts": receipt.n_puts,
                "devices": list(receipt.devices),
                "local_fraction": receipt.local_fraction,
            },
            "global_rows": plan.global_rows,
        }


# ---------------------------------------------------------------------------
# Coordinator (runs in the launcher process)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClusterResult:
    """What a cluster run produced: one record per worker process."""

    records: List[Dict[str, Any]]
    returncodes: List[int]
    run_dir: str

    @property
    def ok(self) -> bool:
        return (
            bool(self.records)
            and all(rc == 0 for rc in self.returncodes)
            and len(self.records) == len(self.returncodes)
        )

    def record(self, process: int) -> Dict[str, Any]:
        for r in self.records:
            if r["process"] == process:
                return r
        raise KeyError(process)


class ClusterCoordinator:
    """Launch + supervise N worker processes.

    The coordinator owns the sync service, the membership directory the
    workers beat into, and the worker subprocesses themselves (fresh
    interpreters through ``subprocess``, never ``fork``: a forked CUDA
    context is unusable).  It holds no model state and touches no device —
    model state lives only in the workers (the paper's host never sees
    gradients, only their sum passing through).
    """

    def __init__(
        self,
        spec: ClusterSpec,
        factory: str,
        factory_kwargs: Optional[Dict[str, Any]] = None,
        *,
        run_dir: Optional[str] = None,
        backend: Optional[str] = None,
    ):
        self.spec = spec
        self.factory = factory
        self.factory_kwargs = dict(factory_kwargs or {})
        self.backend = backend            # the spmd group's; None: by device
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="repro-cluster-")
        self.membership_dir = (
            spec.membership_dir or os.path.join(self.run_dir, "members")
        )
        self._server: Optional[SyncServer] = None
        self._procs: List[subprocess.Popen] = []

    @property
    def processes(self) -> List[subprocess.Popen]:
        return list(self._procs)

    def launch(self, *, resume_steps: int = 2) -> None:
        n = self.spec.processes
        self._server = SyncServer(n, self.spec.sync_port or None)
        os.makedirs(self.membership_dir, exist_ok=True)
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        )))
        for pid in range(n):
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [src_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                              else [])
            )
            cmd = [
                sys.executable, "-m", "repro_torch.launch.cluster", "--worker",
                "--process-id", str(pid),
                "--num-processes", str(n),
                "--sync", self._server.address,
                "--membership-dir", self.membership_dir,
                "--factory", self.factory,
                "--factory-kwargs", json.dumps(self.factory_kwargs),
                "--result", os.path.join(self.run_dir, f"result.p{pid}.json"),
                "--resume-steps", str(resume_steps),
                "--heartbeat-interval", str(self.spec.heartbeat_interval),
                "--transport", json.dumps(self.spec.transport.to_dict()),
                # the spmd process group's rendezvous: a file store no other
                # launch shares (no port to collide on)
                "--rendezvous", f"file://{os.path.join(self.run_dir, 'pg-store')}",
            ] + (["--mode", self.spec.mode] if self.spec.mode else []) \
                + (["--backend", self.backend] if self.backend else [])
            with open(os.path.join(self.run_dir, f"log.p{pid}.txt"), "w") as out:
                self._procs.append(subprocess.Popen(
                    cmd, env=env, stdout=out, stderr=subprocess.STDOUT,
                    cwd=self.run_dir,
                ))

    def kill_worker(self, process_id: int, sig: int = 9) -> None:
        """Elastic-failure injection: hard-kill one worker process."""
        import signal as _signal

        proc = self._procs[process_id]
        proc.send_signal(sig if sig else _signal.SIGKILL)
        if self._server is not None:
            self._server.mark_dead(process_id)

    def wait(self, timeout: float = 600.0) -> ClusterResult:
        deadline = time.time() + timeout
        codes = []
        for proc in self._procs:
            left = max(1.0, deadline - time.time())
            try:
                codes.append(proc.wait(timeout=left))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(-9)
        records = []
        for pid in range(self.spec.processes):
            path = os.path.join(self.run_dir, f"result.p{pid}.json")
            if os.path.isfile(path):
                with open(path) as f:
                    records.append(json.load(f))
        self.close()
        return ClusterResult(
            records=records, returncodes=codes, run_dir=self.run_dir
        )

    def tail_logs(self, lines: int = 30) -> str:
        out = []
        for pid in range(self.spec.processes):
            path = os.path.join(self.run_dir, f"log.p{pid}.txt")
            if os.path.isfile(path):
                with open(path) as f:
                    body = f.read().splitlines()[-lines:]
                out.append(f"--- worker {pid} ---\n" + "\n".join(body))
        return "\n".join(out)

    def close(self) -> None:
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
        if self._server is not None:
            self._server.close()
            self._server = None


def run_cluster(
    spec: ClusterSpec,
    factory: str,
    factory_kwargs: Optional[Dict[str, Any]] = None,
    *,
    run_dir: Optional[str] = None,
    resume_steps: int = 2,
    timeout: float = 600.0,
) -> ClusterResult:
    """Launch a cluster, wait for it, return the per-process records."""
    coord = ClusterCoordinator(
        spec, factory, factory_kwargs, run_dir=run_dir
    )
    coord.launch(resume_steps=resume_steps)
    try:
        return coord.wait(timeout=timeout)
    finally:
        coord.close()


# ---------------------------------------------------------------------------
# The stock session factory (smoke rigs, CI, tests)
# ---------------------------------------------------------------------------


def demo_session_factory(
    *,
    processes: int = 2,
    n_csds: int = 3,
    steps: int = 6,
    seq_len: int = 16,
    arch: str = "deepseek-7b",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    seed: int = 0,
    device: str = "cuda",
    fsdp: bool = False,
):
    """The standard cluster smoke session: ``FleetSpec.demo(n_csds)`` (1 +
    n_csds dp-groups — keep ``(1 + n_csds) % processes == 0``), meshfeed
    storage, cluster mode.  Importable by name from every worker process;
    ``device`` defaults to the card; ``fsdp`` sets the smoke config's flag
    as the published configs set it (ZeRO-3 in the ``spmd`` mode).  (A
    full-width cluster session is the training driver's,
    ``launch/train.py::train_session_factory``.)"""
    from repro_torch.api import FleetSpec, Session, SessionConfig
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.storage import DataConfig

    cfg = smoke_config(arch).with_(fsdp=fsdp)
    spec = FleetSpec.demo(n_csds=n_csds).with_cluster(processes=processes)
    return Session(
        model=get_model(cfg),
        optimizer=adamw(),
        fleet=spec,
        data=DataConfig(vocab=cfg.vocab, seq_len=seq_len, seed=seed),
        shards=spec.shards(private_per_worker={"csd": 64}, public=4096),
        config=SessionConfig(
            total_steps=steps,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every or max(1, steps // 2),
            async_checkpoint=False,
            seed=seed,
        ),
        device=device,
    )


# ---------------------------------------------------------------------------
# Worker CLI entry (what the coordinator spawns)
# ---------------------------------------------------------------------------


def _worker_main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.launch.cluster")
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--sync", default=None)
    ap.add_argument("--membership-dir", default=None)
    ap.add_argument("--factory", required=True)
    ap.add_argument("--factory-kwargs", default="{}")
    ap.add_argument("--result", default=None)
    ap.add_argument("--resume-steps", type=int, default=2)
    ap.add_argument("--heartbeat-interval", type=float, default=0.25)
    ap.add_argument("--transport", default="{}")
    ap.add_argument("--mode", choices=("spmd", "hostsync"), default=None,
                    help="execution mode (default: ClusterContext.detect)")
    ap.add_argument("--rendezvous", default=None,
                    help="spmd process group init_method (file://... or tcp://host:port)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="spmd process group backend (default: nccl on a card, else gloo; "
                         "gloo for ranks that share a card)")
    args = ap.parse_args(argv)

    runtime = WorkerRuntime(
        process_id=args.process_id,
        num_processes=args.num_processes,
        sync_address=args.sync,
        membership_dir=args.membership_dir,
        factory=args.factory,
        factory_kwargs=json.loads(args.factory_kwargs),
        heartbeat_interval=args.heartbeat_interval,
        transport=json.loads(args.transport),
        mode=args.mode,
        rendezvous=args.rendezvous,
        backend=args.backend,
    )
    record = runtime.run(resume_steps=args.resume_steps)
    body = json.dumps(record, indent=1)
    if args.result:
        with open(args.result + ".tmp", "w") as f:
            f.write(body)
        os.replace(args.result + ".tmp", args.result)
    print(body)
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main())
