"""Training driver of the port: the Stannis pipeline through the staged
Session — Algorithm-1 tune, Eq.-1 epoch plan, privacy placement, then
training steps on batches assembled inside the storage devices, in one
process or, with ``--cluster-processes N``, in N worker processes
(:mod:`repro_torch.launch.cluster`), each provisioning only its own
dp-groups' storage devices and landing only its own rows on its device.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --full-config --layers 8 \\
      --seq 256 --precision int8-fused --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --full-config --seq 128 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --full-config --layers 3 --seq 256 --steps 5

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50 \\
      --checkpoint-dir /path/to/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --cluster-processes 2 --csds 3 --steps 4 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --measured-tune \\
      --steps 2 --seq 16

``--full-config`` runs the published dims (random weights from ``--seed``);
``--layers`` cuts the depth, the one cut a single card may need.
``--checkpoint-dir`` saves every ``SessionConfig.checkpoint_every`` (50)
steps and resumes from the newest valid checkpoint there.  ``--device``
defaults to ``cuda``, and the run fails when no card is found (cluster
worker ``p`` on ``cuda:p`` where there is a card a worker, else every worker
on one card; each on the CPU with ``--device cpu``).
``--cluster-processes`` needs ``(1 + csds) % N == 0``; each worker's
``ClusterContext.detect`` picks ``spmd`` (NCCL, a card a worker, no weight
sharded over ``model``) or ``hostsync`` (CPU workers, workers sharing a
card), unless ``--cluster-mode`` names one.  In ``spmd`` a published
config's ``fsdp=True`` shards its weights over ``data``: ZeRO-3, each worker
holding its shards of the parameters and AdamW moments.
``--cluster-local-devices`` above 1 (several devices a process) is
refused, the rest of the second half of ROADMAP item 19; the cluster's mesh
keeps ``model = 1``, as the reference's (tensor and expert parallelism run
on ``launch.mesh.make_host_mesh`` through ``make_spmd_train_step(plan=)``).  ``--measured-tune`` runs Algorithm 1
over real step times (:class:`MeasuredTune`) instead of the fleet's
analytic model.

Every arch trains here as it does in the reference's launcher: the MoE
archs with the router's aux loss in the loss (``SessionConfig.aux_weight``);
qwen2-vl-7b text-only, as its forward takes no patch embeddings from the
fleet's batches.  whisper-medium is refused: its encoder needs frames, and
the fleet's data plane carries none (the reference's launcher fails inside
its encoder).  Both side inputs train through
``train.steps.make_train_step`` with ``frames`` / ``patch_embeds`` in the
batch.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.api import FleetSpec, Session, SessionConfig
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.topology import Fleet
from repro_torch.core.tuner import measured_benchmark
from repro_torch.device import resolve_device
from repro_torch.device import DeviceLike
from repro_torch.models.api import Model, get_model
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.storage import DataConfig
from repro_torch.distributed.sharding import SHARDED_WEIGHTS
from repro_torch.train.steps import make_train_step

PRECISIONS = ("f32", "bf16", "int8-fused")
# the driver's fleet: FleetSpec.demo's keyword arguments beside n_csds
DRIVER_FLEET = dict(host_tput=80.0, csd_tput=10.0, host_max_batch=64, csd_max_batch=8,
                    host_idle=100.0, csd_idle=1.5)


class MeasuredTune:
    """Algorithm 1's benchmark over real step times (the reference's
    ``--measured-tune``, ``launch/train.py:139-163`` there): a class's time
    at a batch is the real train step timed at that batch on this process's
    device (``core.tuner.measured_benchmark``: one warm-up, then the mean of
    3 steps; each step ends in a device sync, reading its loss), scaled
    by the fleet's ``peak_throughput`` ratio of the host to the class (one
    device stands in for every class).

    The step runs on weights of its own, drawn from ``seed`` at the first
    call (the port's optimizer updates in place, so the session's weights
    would move), with fresh optimizer state each call and zero tokens, as
    the reference's.  :meth:`release` frees them (and the device's cached
    blocks) before the session builds its own state; a later re-tune draws
    them again.  ``timings`` lists every (class, batch, seconds) returned."""

    def __init__(self, model: Model, optimizer: str, seq: int, fleet: Fleet,
                 device="cuda", seed: int = 0):
        self.model, self.optimizer, self.seq, self.fleet = model, optimizer, seq, fleet
        self.device, self.seed = resolve_device(device), seed
        self.timings: List[Tuple[str, int, float]] = []
        self._params = None
        self._time = measured_benchmark({"host": self._run_at})

    def _run_at(self, batch: int) -> None:
        if self._params is None:
            self._params, _ = self.model.init_params(seed=self.seed, device=self.device)
        opt = adamw() if self.optimizer == "adamw" else sgd_momentum()
        step = make_train_step(self.model, opt, lambda s: 1e-3)
        toks = torch.zeros((batch, self.seq), dtype=torch.int32, device=self.device)
        b = {"tokens": toks, "labels": toks,
             "loss_mask": torch.ones((batch, self.seq), dtype=torch.float32, device=self.device)}
        _, _, metrics = step(self._params, opt.init(self._params), b)
        float(metrics["loss"])                  # blocks until the step is done

    def __call__(self, name: str, batch: int) -> float:
        rel = (self.fleet.by_name("host").peak_throughput
               / self.fleet.by_name(name).peak_throughput)
        t = self._time("host", batch) * rel
        self.timings.append((name, batch, t))
        return t

    def release(self) -> None:
        self._params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def train_session_factory(
    *,
    arch: str = "deepseek-7b",
    steps: int = 30,
    seq: int = 64,
    csds: int = 2,
    full_config: bool = False,
    n_layers: Optional[int] = None,
    precision: str = "f32",
    optimizer: str = "adamw",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = SessionConfig.checkpoint_every,
    seed: int = 0,
    device: DeviceLike = "cuda",
    cluster_processes: Optional[int] = None,
    fleet: Optional[Dict[str, float]] = None,
    measured_tune: bool = False,
) -> Session:
    """The driver's session: the reference's demo fleet (1 host + ``csds``
    CSD-class workers; ``fleet`` replaces :data:`DRIVER_FLEET`, the rest of
    ``FleetSpec.demo``'s keyword arguments), 256 private samples per CSD
    and a 65,536-sample public pool; importable by name from cluster
    workers (a ``cluster_processes`` count puts the fleet in cluster mode,
    1 included: a one-rank ``spmd`` worker).  ``measured_tune`` gives the
    session a :class:`MeasuredTune` (``session.benchmark``) in place of the
    analytic model."""
    cfg = get_config(arch) if full_config else smoke_config(arch)
    cfg = cfg.with_(train_precision=precision)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    spec = FleetSpec.demo(csds, **(DRIVER_FLEET if fleet is None else fleet))
    if cluster_processes is not None:
        spec = spec.with_cluster(processes=cluster_processes)
    model = get_model(cfg)
    benchmark = (MeasuredTune(model, optimizer, seq, spec.build(), device, seed)
                 if measured_tune else None)
    return Session(
        model=model,
        optimizer=adamw() if optimizer == "adamw" else sgd_momentum(),
        fleet=spec,
        data=DataConfig(vocab=cfg.vocab, seq_len=seq, seed=seed),
        config=SessionConfig(total_steps=steps, checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every, seed=seed),
        shards=spec.shards(private_per_worker={"csd": 256}, public=65536),
        device=device,
        benchmark=benchmark,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--csds", type=int, default=2)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published dims (default: reduced smoke dims)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--precision", default="f32", choices=PRECISIONS,
                    help="ModelConfig.train_precision")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save here, and resume from the newest valid checkpoint here")
    ap.add_argument("--measured-tune", action="store_true",
                    help="tune with real step timings instead of the analytic model")
    ap.add_argument("--cluster-processes", type=int, default=1,
                    help="launch N worker processes")
    ap.add_argument("--cluster-local-devices", type=int, default=0,
                    help=f"devices a worker process: 0 or 1 (more is {SHARDED_WEIGHTS})")
    ap.add_argument("--cluster-mode", choices=("spmd", "hostsync"), default=None,
                    help="the workers' execution mode (default: each worker's "
                         "ClusterContext.detect); spmd trains a config with fsdp=True as "
                         "ZeRO-3 over the data axis (the cluster's mesh keeps model = 1)")
    return ap


def _run_cluster(args) -> int:
    from repro_torch.core.topology import ClusterSpec
    from repro_torch.launch.cluster import run_cluster

    result = run_cluster(
        ClusterSpec(processes=args.cluster_processes,
                    local_devices=args.cluster_local_devices, mode=args.cluster_mode),
        "repro_torch.launch.train:train_session_factory",
        {
            "arch": args.arch, "steps": args.steps, "seq": args.seq, "csds": args.csds,
            "full_config": args.full_config, "n_layers": args.layers,
            "precision": args.precision, "optimizer": args.optimizer,
            "checkpoint_dir": args.checkpoint_dir, "seed": args.seed,
            "device": args.device, "cluster_processes": args.cluster_processes,
        },
    )
    for rec in result.records:
        print(
            f"[proc {rec['process']}/{rec['n_processes']} {rec['mode']}"
            f"{' ' + rec['backend'] if rec.get('backend') else ''}] "
            f"workers={rec['local_workers']} device={rec['device']} "
            f"local_rows={rec['receipt']['rows_local'] if rec['receipt'] else '-'}"
            f"/{rec['global_rows']} compiles={rec['compile_count']} "
            f"digest={rec['param_digest']}"
        )
        if rec["losses"]:
            print(f"  loss {rec['losses'][0]:.4f} -> {rec['losses'][-1]:.4f} "
                  f"addressable_only={rec['addressable_only']}")
    if not result.ok:
        print(f"cluster failed: returncodes={result.returncodes} "
              f"(worker logs under {result.run_dir})", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cluster_local_devices > 1:
        ap.error(f"--cluster-local-devices {args.cluster_local_devices}: a worker process "
                 f"drives one device; more is {SHARDED_WEIGHTS}")
    if args.measured_tune and args.cluster_processes > 1:
        ap.error("--measured-tune times the step in one process; run it without "
                 "--cluster-processes")
    if get_config(args.arch).family == "encdec":
        ap.error(f"{args.arch} trains on audio frames, which the fleet's batches do not "
                 f"carry: train it through train.steps.make_train_step with 'frames' in "
                 f"the batch")
    if args.cluster_processes > 1:
        return _run_cluster(args)

    session = train_session_factory(
        arch=args.arch, steps=args.steps, seq=args.seq, csds=args.csds,
        full_config=args.full_config, n_layers=args.layers, precision=args.precision,
        optimizer=args.optimizer, checkpoint_dir=args.checkpoint_dir, seed=args.seed,
        device=args.device, measured_tune=args.measured_tune,
    )
    cfg = session.model.cfg
    tune_plan = session.tune()
    if args.measured_tune:
        for name, batch, t in session.benchmark.timings:
            print(f"  measured {name} batch {batch}: {t * 1e3:.1f} ms")
        session.benchmark.release()
    epoch = session.plan()
    shard_plan = session.shard()
    print(f"arch={cfg.name} layers={cfg.n_layers} params={cfg.param_count():,} "
          f"precision={cfg.train_precision} device={session.device}")
    print(f"tuned batches: {tune_plan.batches} "
          f"(margin {tune_plan.result.margin:.0%}, ref={tune_plan.result.reference_class})")
    print(f"schedule: groups={tune_plan.schedule.group_batches} "
          f"pad={tune_plan.schedule.pad_fraction:.1%}")
    print(f"epoch: {epoch.steps_per_epoch} steps, imbalance {epoch.imbalance_steps()} steps")
    print(f"sharding: {shard_plan.describe()}")

    session.callbacks.on_step(
        lambda i, m: print(
            f"  step {i:4d} loss {m['loss']:.4f} lr {m['lr']:.2e} "
            f"gnorm {m['grad_norm']:.2f} ({m['step_time'] * 1e3:.0f} ms)"
        ) if i % 5 == 0 else None
    )
    report = session.run()
    hist = report.history
    if report.start_step:
        print(f"resumed from the checkpoint at step {report.start_step}")
    if not hist:
        print(f"nothing to run: the checkpoint is at step {report.start_step} of {args.steps}")
        return 0
    print(f"{report.steps_run} steps in {report.wall_time:.1f}s; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
