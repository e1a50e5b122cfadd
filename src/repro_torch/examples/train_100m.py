"""Train a ~100M-parameter dense LM through the full Stannis pipeline (tune ->
balance -> place -> train) with checkpoint/restart fault tolerance (port of
``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300 --interrupt-at 150

Checkpoints go to ``--checkpoint-dir`` every ``--checkpoint-every`` steps; a
second run over the same directory resumes from the newest valid one.
``--interrupt-at N`` shows the restart in one command: a first session stops
after step N, as if its process died, and a fresh session over the same
directory resumes from the newest checkpoint, batcher cursors included, and
runs to ``--steps``.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.api import FleetSpec, Session, SessionConfig
from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.storage import DataConfig

# ~100M params: 12L x 768 (GPT-small-ish geometry, llama-style blocks)
CONFIG = ModelConfig(
    name="dense-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=2048, vocab=32768, remat=False,
)


def make_session(args) -> Session:
    spec = FleetSpec.demo(n_csds=2, host_tput=50.0, csd_tput=12.0,
                          host_max_batch=8, csd_max_batch=2)
    session = Session(
        model=get_model(CONFIG),
        optimizer=adamw(weight_decay=0.01),
        fleet=spec,
        data=DataConfig(vocab=CONFIG.vocab, seq_len=args.seq),
        shards=spec.shards(private_per_worker={"csd": 512}, public=1 << 20),
        config=SessionConfig(
            total_steps=args.steps,
            base_lr=3e-4,
            warmup_steps=30,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            async_checkpoint=True,
        ),
        device=args.device,
    )
    session.callbacks.on_step(
        lambda i, m: print(
            f"  step {i:4d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
            f"{m['step_time'] * 1e3:.0f} ms"
        ) if i % 25 == 0 else None)
    return session


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--interrupt-at", type=int, default=None,
                    help="stop the first session after this step, then resume in a new one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"params: {CONFIG.param_count():,}")

    session = make_session(args)
    tune_plan = session.tune()
    print("tuned:", tune_plan.batches,
          "| schedule:", tune_plan.schedule.group_batches,
          "| epoch:", session.plan().steps_per_epoch, "steps")
    if args.interrupt_at is not None:
        first = session.run(steps=args.interrupt_at)
        print(f"interrupted after step {first.start_step + first.steps_run}")
        session = make_session(args)
    report = session.run()
    hist = report.history
    if report.start_step:
        print(f"resumed from the checkpoint at step {report.start_step}")
    if not hist:
        print(f"nothing to run: the checkpoint is at step {report.start_step}")
        return 0
    tok_s = sum(h["tokens"] for h in hist) / max(report.wall_time, 1e-9)
    print(f"done: {report.steps_run} steps in {report.wall_time:.0f}s "
          f"({tok_s:,.0f} tok/s); loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
