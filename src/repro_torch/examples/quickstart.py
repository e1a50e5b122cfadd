"""Quickstart: the Stannis pipeline end to end through the port's Session API
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.api import FleetSpec, Session, SessionConfig, TrainReport
from repro_torch.configs import smoke_config
from repro_torch.device import DeviceLike
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.storage import DataConfig

SEQ = 32


def make_session(steps: int = 20, device: DeviceLike = "cuda") -> Session:
    # 1. A heterogeneous fleet: one fast "host" class + two slow "CSD"-class
    #    workers (the paper's Newport role, scaled down).  Each worker gets a
    #    storage device; swap the data plane with one line, e.g.
    #    FleetSpec.demo(n_csds=2).with_storage("flash").
    spec = FleetSpec.demo(n_csds=2)
    # 2. Data: private shards pinned to their owners + a public pool.
    shards = spec.shards(private_per_worker={"csd": 64}, public=4096)
    # 3. Model: reduced dims of deepseek-7b.
    cfg = smoke_config("deepseek-7b")
    return Session(
        model=get_model(cfg),
        optimizer=adamw(),
        fleet=spec,
        data=DataConfig(vocab=cfg.vocab, seq_len=SEQ),
        shards=shards,
        config=SessionConfig(total_steps=steps),
        device=device,
    )


def main(argv=None, params: Optional[dict] = None) -> TrainReport:
    """Run the quickstart; ``params`` replaces the seeded initial weights."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    session = make_session(args.steps, args.device)

    # Each stage is an explicit, cached, inspectable artifact.
    tune_plan = session.tune()      # Algorithm 1
    epoch = session.plan()          # Eq. 1
    manifest = session.place()      # privacy placement, fleet-aware

    print("Algorithm-1 tuned batches :", tune_plan.batches)
    print("storage devices           :",
          {d.worker: f"{d.backend}:{len(d.custody)} shards" for d in manifest.devices})
    print("Eq.-1 steps per epoch     :", epoch.steps_per_epoch,
          f"(imbalance {epoch.imbalance_steps()} steps)")
    print("group schedule            :", tune_plan.schedule.group_batches,
          f"pad {tune_plan.schedule.pad_fraction:.0%}")

    session.callbacks.on_step(
        lambda i, m: print(f"  step {i:3d}  loss {m['loss']:.4f}") if i % 5 == 0 else None)
    report = session.run(params)
    print(f"loss {report.history[0]['loss']:.4f} -> {report.final_loss:.4f}")
    return report


if __name__ == "__main__":
    main()
