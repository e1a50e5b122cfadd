"""Training driver of the port: the Stannis pipeline through the staged
Session on one device — Algorithm-1 tune, Eq.-1 epoch plan, privacy
placement, then training steps on batches assembled inside the storage
devices.

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

``--full-config`` runs the published dims (random weights from ``--seed``);
``--layers`` cuts the depth, the one cut a single card may need.
``--checkpoint-dir`` saves every ``SessionConfig.checkpoint_every`` (50)
steps and resumes from the newest valid checkpoint there.  ``--device``
defaults to ``cuda``, and the run fails when no card is found.  Not
ported yet, each refused with its ROADMAP item: ``--cluster-processes > 1``
and ``--measured-tune``.

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
from typing import Optional

from repro_torch.api import FleetSpec, Session, SessionConfig
from repro_torch.api.session import ROADMAP_CLUSTER
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.device import DeviceLike
from repro_torch.models.api import get_model
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.storage import DataConfig

ROADMAP_MEASURED_TUNE = "ROADMAP item 14 'Drivers and benches'"
PRECISIONS = ("f32", "bf16", "int8-fused")


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
) -> Session:
    """The driver's session: the reference's demo fleet (1 host + ``csds``
    CSD-class workers), 256 private samples per CSD and a 65,536-sample
    public pool."""
    cfg = get_config(arch) if full_config else smoke_config(arch)
    cfg = cfg.with_(train_precision=precision)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    spec = FleetSpec.demo(
        csds, host_tput=80.0, csd_tput=10.0,
        host_max_batch=64, csd_max_batch=8,
        host_idle=100.0, csd_idle=1.5,
    )
    return Session(
        model=get_model(cfg),
        optimizer=adamw() if optimizer == "adamw" else sgd_momentum(),
        fleet=spec,
        data=DataConfig(vocab=cfg.vocab, seq_len=seq, seed=seed),
        config=SessionConfig(total_steps=steps, checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every, seed=seed),
        shards=spec.shards(private_per_worker={"csd": 256}, public=65536),
        device=device,
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
                    help=f"not ported ({ROADMAP_MEASURED_TUNE})")
    ap.add_argument("--cluster-processes", type=int, default=1,
                    help=f"values above 1 are not ported ({ROADMAP_CLUSTER})")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cluster_processes > 1:
        ap.error(f"--cluster-processes > 1 is not ported to repro_torch yet ({ROADMAP_CLUSTER})")
    if args.measured_tune:
        ap.error(f"--measured-tune is not ported to repro_torch yet ({ROADMAP_MEASURED_TUNE})")
    if get_config(args.arch).family == "encdec":
        ap.error(f"{args.arch} trains on audio frames, which the fleet's batches do not "
                 f"carry: train it through train.steps.make_train_step with 'frames' in "
                 f"the batch")

    session = train_session_factory(
        arch=args.arch, steps=args.steps, seq=args.seq, csds=args.csds,
        full_config=args.full_config, n_layers=args.layers, precision=args.precision,
        optimizer=args.optimizer, checkpoint_dir=args.checkpoint_dir, seed=args.seed,
        device=args.device,
    )
    cfg = session.model.cfg
    tune_plan = session.tune()
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
