#!/usr/bin/env python3
"""How far does a rounding-sized difference in one step's gradients move the
next steps' losses of the whisper-medium and qwen2-vl-7b smoke configs?

Three steps of ``train.steps.make_train_step`` on the CPU (float32, 4 rows
of 16 tokens, stub frames / 4 stub patches drawn from a seed, the goyal
schedule at 4 rows), once as is and once with every gradient leaf of every
step perturbed by Gaussian noise of ``noise`` times that leaf's largest |g|,
under AdamW and under SGD with momentum, from the port's seed-0 weights and
from ``chip_smoke.fan_in_weights`` of them.  It prints the per-step losses
and the largest relative loss difference.

AdamW's first update is lr * g / (|g| + eps): every coordinate moves by
about +-lr whatever its size, so a coordinate whose gradient is rounding
noise moves by +-lr on a sign that noise picks.  SGD's update moves each
coordinate in proportion to its gradient.  This is why ``chip_smoke.py``
holds these two configs' CPU-vs-card losses under SGD, from fan-in weights.

    PYTHONPATH=src python scripts/side_train_noise_probe.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ROWS, SEQ, N_PATCHES, STEPS = 4, 16, 4, 3


def main() -> int:
    import copy

    import torch

    from chip_smoke import fan_in_weights
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw, goyal_schedule, sgd_momentum
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train import steps as S

    def batches(cfg):
        gen = torch.Generator()
        gen.manual_seed(28)
        out = []
        for _ in range(STEPS):
            b = {k: torch.randint(0, cfg.vocab, (ROWS, SEQ), generator=gen, dtype=torch.int32)
                 for k in ("tokens", "labels")}
            b["loss_mask"] = torch.ones(ROWS, SEQ)
            if cfg.family == "encdec":
                b["frames"] = torch.randn(ROWS, cfg.n_frames, cfg.d_model, generator=gen)
            else:
                b["patch_embeds"] = torch.randn(ROWS, N_PATCHES, cfg.d_model, generator=gen)
            out.append(b)
        return out

    def run(cfg, params, make_opt, noise):
        model, opt = get_model(cfg), make_opt()
        sched = goyal_schedule(1e-3, ROWS, base_batch=256, warmup_steps=20, total_steps=STEPS)
        gen = torch.Generator()
        gen.manual_seed(5)

        def perturb(grads):
            return tree_map(lambda g: g + noise * g.abs().max() * torch.randn(
                g.shape, generator=gen), grads)

        step = S.make_train_step(model, opt, sched, grad_transform=perturb if noise else None)
        p, state, losses = copy.deepcopy(params), opt.init(params), []
        for b in batches(cfg):
            p, state, m = step(p, state, b)
            losses.append(float(m["loss"]))
        return losses

    for arch in ("whisper-medium", "qwen2-vl-7b"):
        cfg = smoke_config(arch)
        port, _ = get_model(cfg).init_params(seed=0, device="cpu")
        for init, params in (("port init", port), ("fan-in", fan_in_weights(torch, port, 3))):
            for name, make_opt in (("adamw", adamw), ("sgd", sgd_momentum)):
                base = run(cfg, params, make_opt, 0.0)
                for noise in (1e-6, 1e-5):
                    got = run(cfg, params, make_opt, noise)
                    rel = max(abs(a - b) / abs(b) for a, b in zip(got, base))
                    print(f"{arch} {init} {name} noise {noise:.0e} of each leaf's max |g|: "
                          f"losses {[round(x, 6) for x in base]} -> "
                          f"{[round(x, 6) for x in got]}, largest relative difference {rel:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
