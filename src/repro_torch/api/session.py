"""`Session`: the staged entry point of the Stannis training pipeline (port
of :mod:`repro.api.session`, single process, one torch device).

    session = Session(model=model, optimizer=adamw(),
                      fleet=FleetSpec.demo(2), data=DataConfig(...),
                      shards=spec.shards(...), config=SessionConfig(...))
    tune_plan = session.tune()      # Algorithm 1 -> TunePlan
    epoch     = session.plan()      # Eq. 1       -> EpochPlan
    manifest  = session.place()     # privacy     -> FleetManifest (device-aware)
    shard     = session.shard()     # one device  -> ShardingPlan
    step      = session.compile()   # train step  -> CompiledStep
    report    = session.run()       # training    -> TrainReport

The data plane is the :mod:`repro_torch.storage` device fleet: each
dp-group's rows are assembled in its own storage device and the stitched
batch lands on the session's device.  Stages are lazy and memoized; a stage
can be overridden (``session.override("tune", plan)``), which invalidates
everything downstream of it.

All mid-run fleet changes go through ONE replanning path,
:meth:`Session.apply`:

    session.apply(WorkerLost(["csd/1"]))   # paper's backfill remedy
    session.apply(WorkerJoined("csd", 2))  # elastic growth
    session.apply(DriftDetected())         # online re-tune, zero recompile

``apply`` keeps the pinned row capacity across events, so a drift re-tune
keeps the compiled step (the ``compile_count`` probe) and a node loss keeps
``max_local``, so only the group count changes.  A lost worker's private
shards are quarantined and its public custody moves to a survivor
(``DeviceFleet.quarantine_workers``).  With ``config.checkpoint_dir`` set,
``run`` saves every ``checkpoint_every`` steps and resumes from the newest
valid checkpoint, the batcher's cursors included, so a restart replays no
data.

The session runs on the card unless told otherwise (``device="cuda"``; it
raises when no card is visible).  Cluster execution (hostsync /
multi-process) is not ported yet and raises ``NotImplementedError`` naming
its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.api.artifacts import (
    CompiledStep, ReplanResult, ShardingPlan, TrainReport, TunePlan,
)
from repro_torch.api.callbacks import CallbackRegistry
from repro_torch.api.events import DriftDetected, FleetEvent, WorkerJoined, WorkerLost
from repro_torch.api.fleet import FleetSpec
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.hetero import BatchSchedule, schedule_from_tune
from repro_torch.core.load_balance import EpochPlan, plan_epoch
from repro_torch.core.privacy import Shard, place
from repro_torch.core.topology import Fleet
from repro_torch.core.tuner import BenchmarkFn, DriftMonitor, tune
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import Model
from repro_torch.optim.optimizers import Optimizer, tree_map
from repro_torch.optim.schedules import goyal_schedule
from repro_torch.storage import (
    DataConfig, DeviceFleet, FleetBatcher, FleetManifest, StorageSpec,
    make_fleet_batcher, manifest_sources,
)
from repro_torch.train.steps import make_train_step

PyTree = Any

ROADMAP_CLUSTER = "ROADMAP item 13 'Multi-device and multi-process'"

# stage dependency graph: invalidating a stage clears it plus everything
# that derives from it ("shard"/"compile" depend only on the tune schedule)
_STAGES = ("tune", "plan", "place", "dataset", "shard", "compile")
_DOWNSTREAM = {
    "tune": ("plan", "place", "dataset", "shard", "compile"),
    "plan": ("place", "dataset"),
    "place": ("dataset",),
    "dataset": (),
    "shard": ("compile",),
    "compile": (),
}


@dataclasses.dataclass
class SessionConfig:
    """Run-level knobs (training length, LR rule, checkpointing, drift).

    Mutable by design (unlike the stage artifacts): callers tweak e.g.
    ``total_steps`` or ``retune_margin`` between runs of the same session.
    """

    total_steps: int = 100
    base_lr: float = 1e-3
    base_batch: int = 256
    warmup_steps: int = 20
    aux_weight: float = 0.01
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    retune_margin: float = 0.2       # DriftMonitor threshold = tuner 1/E
    retune_patience: int = 10
    log_every: int = 10
    seed: int = 0


class Session:
    """Staged pipeline: tune -> plan -> place -> shard -> compile -> run."""

    def __init__(
        self,
        *,
        model: Model,
        optimizer: Optimizer,
        fleet: Union[Fleet, FleetSpec],
        data: DataConfig,
        shards: Sequence[Shard],
        config: Optional[SessionConfig] = None,
        benchmark: Optional[BenchmarkFn] = None,
        callbacks: Optional[CallbackRegistry] = None,
        storage: Optional[StorageSpec] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        spec_storage = fleet.storage if isinstance(fleet, FleetSpec) else None
        self.fleet: Fleet = fleet.build() if isinstance(fleet, FleetSpec) else fleet
        self.data = data
        self._shards: List[Shard] = list(shards)
        self.config = config or SessionConfig()
        self.benchmark = benchmark
        self.callbacks = callbacks or CallbackRegistry()
        # the storage data plane: explicit arg > FleetSpec.storage > default
        self.storage: StorageSpec = storage or spec_storage or StorageSpec()
        # the device fleet persists across stage rebuilds (custody state)
        self._device_fleet: Optional[DeviceFleet] = None
        self._artifacts: Dict[str, Any] = {}
        self._compile_count = 0
        # WorkerClass templates survive a fully-dead class leaving the fleet,
        # so a replacement node can still rejoin under the same class name
        self._class_templates: Dict[str, Any] = {c.name: c for c in self.fleet.classes}
        # canonical live membership: survives stage rebuilds (tune(force=True)
        # must not resurrect dead workers from bare class counts)
        self._group_workers: Optional[Tuple[str, ...]] = None
        # per-class high-water mark of worker indices ever handed out, so a
        # joiner is never labelled as a dead worker
        self._next_index: Dict[str, int] = {}
        # the checkpoint manager of the last run with a checkpoint_dir (its
        # last save's snapshot and write times)
        self.checkpoints: Optional[CheckpointManager] = None

    def _note_labels(self, workers: Sequence[str]) -> None:
        for w in workers:
            cls, idx = w.rsplit("/", 1)
            self._next_index[cls] = max(self._next_index.get(cls, 0), int(idx) + 1)

    # -- cluster mode (not ported) ------------------------------------------

    def attach_cluster(self, ctx: Any) -> None:
        raise NotImplementedError(
            f"cluster execution is not ported to repro_torch yet ({ROADMAP_CLUSTER})")

    # -- introspection -----------------------------------------------------

    @property
    def shards(self) -> Tuple[Shard, ...]:
        """Live shard set (shrinks when an owner dies — privacy constraint)."""
        return tuple(self._shards)

    @property
    def compile_count(self) -> int:
        """How many times a CompiledStep was built (the no-recompile probe)."""
        return self._compile_count

    @property
    def devices(self) -> DeviceFleet:
        """The live storage device fleet (provisioned on first access)."""
        if self._device_fleet is None:
            tp = self.tune()
            self._device_fleet = DeviceFleet.provision(
                tp.group_workers, self._shards, self.data, spec=self.storage,
            )
        return self._device_fleet

    def cached(self, stage: str) -> bool:
        return stage in self._artifacts

    def override(self, stage: str, artifact: Any) -> None:
        """Install a caller-supplied artifact for ``stage``; downstream stages
        are invalidated and will rebuild against it on next access."""
        if stage not in _STAGES:
            raise KeyError(f"unknown stage {stage!r}; stages are {_STAGES}")
        self._invalidate(stage)
        self._artifacts[stage] = artifact
        if stage == "tune":
            # an externally supplied TunePlan defines the live membership
            self._group_workers = tuple(artifact.group_workers)
            self._note_labels(artifact.group_workers)

    def _invalidate(self, from_stage: str) -> None:
        self._artifacts.pop(from_stage, None)
        for s in _DOWNSTREAM[from_stage]:
            self._artifacts.pop(s, None)

    # -- stage 1: Algorithm 1 ---------------------------------------------

    def tune(self, *, force: bool = False) -> TunePlan:
        prev = self._artifacts.get("tune")
        prev_compiled = self._artifacts.get("compile")
        prev_shard = self._artifacts.get("shard")
        if force:
            self._invalidate("tune")
        if "tune" not in self._artifacts:
            result = tune(self.fleet, self.benchmark)
            if self._group_workers is None:
                # first tune: physical workers are enumerated from class counts
                class_counts = {c.name: c.count for c in self.fleet.classes}
                schedule, workers = schedule_from_tune(result.batches, class_counts)
                self._group_workers = tuple(workers)
            else:
                # rebuild: keep the live membership, map per-class batches onto it
                workers = self._group_workers
                new_batches = tuple(result.batches[w.rsplit("/", 1)[0]] for w in workers)
                if prev is not None and prev.group_workers == workers:
                    # preserve the pinned capacity: a re-tune that fits
                    # under it keeps the compiled shapes
                    schedule = prev.schedule.with_batches(new_batches)
                else:
                    schedule = BatchSchedule(new_batches)
            self._note_labels(workers)
            self._artifacts["tune"] = TunePlan(
                result=result, schedule=schedule, group_workers=tuple(workers))
            if prev_shard is not None and prev_shard.global_rows == schedule.global_rows:
                self._artifacts["shard"] = prev_shard
            if prev_compiled is not None and prev_compiled.global_rows == schedule.global_rows:
                self._artifacts["compile"] = prev_compiled
        return self._artifacts["tune"]

    # -- stage 2: Eq. 1 epoch balancing -----------------------------------

    def plan(self, *, force: bool = False) -> EpochPlan:
        if force:
            self._invalidate("plan")
        if "plan" not in self._artifacts:
            tp = self.tune()
            batches = dict(zip(tp.group_workers, tp.schedule.group_batches))
            private_sizes = {w: 0 for w in tp.group_workers}
            n_public = 0
            for s in self._shards:
                if s.private:
                    private_sizes[s.owner] = private_sizes.get(s.owner, 0) + s.n_samples
                else:
                    n_public += s.n_samples
            self._artifacts["plan"] = plan_epoch(batches, private_sizes, n_public)
        return self._artifacts["plan"]

    # -- stage 3: privacy placement ---------------------------------------

    def place(self, *, force: bool = False) -> FleetManifest:
        """Privacy placement, fleet-aware: the core manifest wrapped with
        per-device custody records."""
        if force:
            self._invalidate("place")
        if "place" not in self._artifacts:
            epoch = self.plan()
            targets = {sh.worker: sh.total for sh in epoch.shares}
            core = place(list(self._shards), targets)
            self._artifacts["place"] = self.devices.manifest(core)
        return self._artifacts["place"]

    # -- stage 3b: data pipeline (derived from plan + place) -----------------

    @property
    def dataset(self) -> FleetBatcher:
        if "dataset" not in self._artifacts:
            tp = self.tune()
            self._artifacts["dataset"] = make_fleet_batcher(
                self.data, tp.schedule, list(tp.group_workers), self.place(), self.devices,
            )
        return self._artifacts["dataset"]

    # -- stage 4: the (one-device) sharding plan -------------------------------

    def shard(self, *, force: bool = False) -> ShardingPlan:
        """The placement every downstream consumer reads; keyed by the
        schedule's ``global_rows`` like the reference's plan."""
        if force:
            self._invalidate("shard")
        tp = self.tune()
        cached = self._artifacts.get("shard")
        if cached is not None and cached.global_rows != tp.schedule.global_rows:
            self._invalidate("shard")
        if "shard" not in self._artifacts:
            self._artifacts["shard"] = ShardingPlan(
                device=self.device, global_rows=tp.schedule.global_rows)
        return self._artifacts["shard"]

    # -- stage 5: the train step -------------------------------------------

    def _config_key(self) -> Tuple:
        """The SessionConfig values baked into the compiled step."""
        cfg = self.config
        return (cfg.base_lr, cfg.base_batch, cfg.warmup_steps, cfg.total_steps,
                cfg.aux_weight)

    def compile(self, *, force: bool = False) -> CompiledStep:
        if force:
            self._invalidate("compile")
        cached = self._artifacts.get("compile")
        if cached is not None and cached.config_key != self._config_key():
            # config edits between runs must take effect (the step bakes in
            # the lr schedule); drift re-tunes deliberately do NOT count
            self._invalidate("compile")
        if "compile" not in self._artifacts:
            tp = self.tune()
            self.shard()
            sched = goyal_schedule(
                self.config.base_lr,
                tp.schedule.valid_rows,
                base_batch=self.config.base_batch,
                warmup_steps=self.config.warmup_steps,
                total_steps=self.config.total_steps,
            )
            step = make_train_step(self.model, self.optimizer, sched,
                                   aux_weight=self.config.aux_weight)
            self._compile_count += 1
            self._artifacts["compile"] = CompiledStep(
                step_fn=step,
                global_rows=tp.schedule.global_rows,
                seq_len=self.data.seq_len,
                valid_rows=tp.schedule.valid_rows,
                build_id=self._compile_count,
                config_key=self._config_key(),
            )
        return self._artifacts["compile"]

    # -- state ---------------------------------------------------------------

    def init_state(self, *, seed: Optional[int] = None,
                   init_opt: bool = True) -> Tuple[PyTree, Any]:
        """Fresh (params, opt_state) on the session's device, weights from a
        ``torch.Generator`` seeded with ``seed`` (default ``config.seed``)."""
        seed = self.config.seed if seed is None else seed
        params, _ = self.model.init_params(seed=seed, device=self.device)
        return params, (self.optimizer.init(params) if init_opt else None)

    def _adopt_state(self, tree: PyTree) -> PyTree:
        """Caller-supplied state onto the session's device (no copy when it
        is there already)."""
        return tree_map(lambda t: t.to(self.device), tree)

    # -- training --------------------------------------------------------------

    def run(
        self,
        params: Optional[PyTree] = None,
        *,
        opt_state: Optional[Any] = None,
        steps: Optional[int] = None,
    ) -> TrainReport:
        """Train.  Pass a prior report's ``params`` AND ``opt_state`` to
        continue after an elastic event — the optimizer's moments and the
        lr-schedule step counter live in ``opt_state``.  The step updates both
        IN PLACE (the JAX package donates them): pass copies to keep the
        originals.  With ``config.checkpoint_dir`` holding a valid
        checkpoint, training resumes from it and the caller's state is
        ignored."""
        cfg = self.config
        steps = steps or cfg.total_steps
        compiled = self.compile()
        ckpt = None
        if cfg.checkpoint_dir:
            ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
            self.checkpoints = ckpt
        start_step = 0
        if ckpt is not None and ckpt.latest_step() is not None:
            # restart-after-failure: the newest valid checkpoint, every leaf
            # straight onto the session's device, and the SAMPLING state too:
            # without the cursors a restart replays already-seen batches
            like, _ = self.model.init_params(abstract=True)
            state, meta = ckpt.restore(
                {"params": like, "opt": self.optimizer.init(like)}, device=self.device)
            params, opt_state = state["params"], state["opt"]
            start_step = int(meta.get("step", ckpt.latest_step()))
            self.dataset.set_cursors(meta.get("cursors") or {})
        else:
            if params is None:
                params, fresh_opt = self.init_state(init_opt=opt_state is None)
                opt_state = opt_state if opt_state is not None else fresh_opt
            else:
                params = self._adopt_state(params)
            if opt_state is None:
                opt_state = self.optimizer.init(params)
            else:
                opt_state = opt_state._replace(
                    mu=self._adopt_state(opt_state.mu),
                    nu=None if opt_state.nu is None else self._adopt_state(opt_state.nu))

        dataset = self.dataset
        monitor = DriftMonitor(margin=cfg.retune_margin, patience=cfg.retune_patience)
        history: List[Dict[str, float]] = []
        t0 = time.perf_counter()
        for i in range(start_step, steps):
            # each dp-group's rows are assembled in its storage device
            td = time.perf_counter()
            batch = dataset.next_device_batch(self.device)
            ts = time.perf_counter()
            params, opt_state, metrics = compiled.step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # waits for the device
            metrics["step_time"] = time.perf_counter() - ts
            metrics["data_time"] = ts - td
            history.append(metrics)
            self.callbacks.emit_step(i, metrics)

            # straggler watch: per-class analytic step times
            tp = self.tune()
            class_times = {
                c.name: self.fleet.by_name(c.name).step_time(tp.result.batches[c.name])
                for c in self.fleet.classes
                if c.name in tp.result.batches
            }
            if monitor.update(class_times):
                self.apply(DriftDetected(source="monitor"))
                compiled = self.compile()   # same object unless shapes grew
                dataset = self.dataset

            if ckpt is not None and (i + 1) % cfg.checkpoint_every == 0:
                ckpt.save(
                    i + 1, {"params": params, "opt": opt_state},
                    metadata={
                        "step": i + 1,
                        "schedule": list(self.tune().schedule.group_batches),
                        "cursors": dataset.cursors(),
                    },
                    async_=cfg.async_checkpoint,
                )
                self.callbacks.emit_checkpoint(i + 1, cfg.checkpoint_dir)
        if ckpt is not None:
            ckpt.wait()
        return TrainReport(
            params=params,
            opt_state=opt_state,
            history=tuple(history),
            steps_run=len(history),
            start_step=start_step,
            compile_count=self._compile_count,
            wall_time=time.perf_counter() - t0,
        )

    # -- the ONE elastic replanning path ---------------------------------------

    def apply(self, event: FleetEvent) -> ReplanResult:
        """Route any elastic fleet event through one replanning code path.

        The pinned row ``capacity`` always survives the event, so shapes only
        change when the group COUNT changes (node loss/join) — never on a
        drift re-tune.
        """
        old = self.tune()
        dropped: Tuple[str, ...] = ()

        if isinstance(event, DriftDetected):
            # membership never changes on drift: re-tune per-CLASS batches and
            # map them onto the CURRENT group workers (which may already
            # reflect earlier losses/joins); capacity-pinned, so same shapes
            result = tune(self.fleet, self.benchmark)
            new_batches = tuple(result.batches[w.rsplit("/", 1)[0]] for w in old.group_workers)
            new = TunePlan(result=result, schedule=old.schedule.with_batches(new_batches),
                           group_workers=old.group_workers)

        elif isinstance(event, WorkerLost):
            dead = set(event.workers)
            missing = dead - set(old.group_workers)
            if missing:
                raise KeyError(f"unknown workers {sorted(missing)}")
            keep = [(w, b) for w, b in zip(old.group_workers, old.schedule.group_batches)
                    if w not in dead]
            if not keep:
                raise ValueError("cannot lose every worker in the fleet")
            # shrink the fleet's class counts so later tunes/joins see the
            # true membership (a fully-dead class leaves the fleet)
            lost_per_class: Dict[str, int] = {}
            for w in dead:
                cls = w.rsplit("/", 1)[0]
                lost_per_class[cls] = lost_per_class.get(cls, 0) + 1
            self.fleet = Fleet(classes=tuple(
                dataclasses.replace(c, count=c.count - lost_per_class.get(c.name, 0))
                for c in self.fleet.classes
                if c.count - lost_per_class.get(c.name, 0) > 0
            ))
            # paper's remedy, through the fleet custody API: the dead
            # workers' private shards are quarantined (tombstoned on every
            # surviving device), their public custody re-homes to survivors;
            # plan_epoch rebalances the share
            dropped = self.devices.quarantine_workers(sorted(dead))
            self._shards = [s for s in self._shards if not (s.private and s.owner in dead)]
            # pin capacity to the pre-event max_local: fewer groups, same
            # per-group row count
            schedule = BatchSchedule(tuple(b for _, b in keep),
                                     round_to=old.schedule.round_to,
                                     capacity=old.schedule.max_local)
            new = TunePlan(result=old.result, schedule=schedule,
                           group_workers=tuple(w for w, _ in keep))

        elif isinstance(event, WorkerJoined):
            if any(c.name == event.class_name for c in self.fleet.classes):
                self.fleet = Fleet(classes=tuple(
                    dataclasses.replace(c, count=c.count + event.count)
                    if c.name == event.class_name else c
                    for c in self.fleet.classes
                ))
            elif event.class_name in self._class_templates:
                # the class fully died earlier; revive it from its template
                self.fleet = Fleet(classes=self.fleet.classes + (
                    dataclasses.replace(self._class_templates[event.class_name],
                                        count=event.count),
                ))
            else:
                raise KeyError(event.class_name)
            result = tune(self.fleet, self.benchmark)
            # survivors keep their labels (private shards stay pinned to their
            # owners); joiners draw never-used indices from the high-water
            # mark, so a dead worker's label is never recycled
            start = self._next_index.get(event.class_name, 0)
            self._next_index[event.class_name] = start + event.count
            joiners = tuple(f"{event.class_name}/{start + i}" for i in range(event.count))
            workers = old.group_workers + joiners
            # fresh storage devices for the joiners: they hold the public
            # pool; no private shards exist for a new worker yet
            for w in joiners:
                self.devices.provision_worker(w)
            schedule = BatchSchedule(
                tuple(result.batches[w.rsplit("/", 1)[0]] for w in workers),
                round_to=old.schedule.round_to,
                capacity=old.schedule.max_local,   # never shrinks; growth
            )                                      # beyond it recompiles
            new = TunePlan(result=result, schedule=schedule, group_workers=workers)

        else:
            raise TypeError(f"unknown fleet event {event!r}")

        # ---- shared tail: install the new TunePlan, re-plan, re-place ----
        compiled = self._artifacts.get("compile")
        keep_compiled = compiled is not None and compiled.global_rows == new.schedule.global_rows
        shard_plan = self._artifacts.get("shard")
        keep_shard = shard_plan is not None and shard_plan.global_rows == new.schedule.global_rows
        dataset = self._artifacts.get("dataset")
        keep_dataset = dataset is not None and new.group_workers == old.group_workers
        self.override("tune", new)          # invalidates plan/place/dataset
        if keep_shard:
            self._artifacts["shard"] = shard_plan
        if keep_compiled:
            self._artifacts["compile"] = compiled
        self.plan()
        self.place()
        if keep_dataset:
            # same membership (drift re-tune): rewire the live iterator to the
            # re-planned schedule and placement; per-worker epoch cursors
            # survive (no replay of already-seen data)
            dataset.rewire(new.schedule, manifest_sources(self.place(), list(new.group_workers)))
            self._artifacts["dataset"] = dataset
        else:
            _ = self.dataset
        result_obj = ReplanResult(
            event=event, tune_plan=new,
            # only a real invalidation counts: with no step built yet,
            # nothing was thrown away
            recompiled=compiled is not None and not keep_compiled,
            dropped_shards=dropped,
        )
        if isinstance(event, DriftDetected):
            self.callbacks.emit_retune(event, new)
        else:
            self.callbacks.emit_fleet_change(event, result_obj)
        return result_obj
