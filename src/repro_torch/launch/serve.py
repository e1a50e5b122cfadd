"""Serving driver of the port: one-shot generate, engine streaming, or load
generation, on the card.

  * ``oneshot``: :meth:`repro_torch.api.serving.ServeSession.generate`
    (prefill + decode loop, the parity oracle);
  * ``engine``: :class:`repro_torch.serve.ServeEngine` with streaming events
    printed as they arrive (continuous batching visible on the console);
  * ``loadgen``: :func:`repro_torch.serve.run_load`, closed-loop synthetic
    users; prints the req/s and latency-percentile report.

  PYTHONPATH=src python -m repro_torch.launch.serve --full-config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full-config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine --requests 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode loadgen --requests 64 \
      --shared-prefix 16 --device cpu

``--arch`` takes any arch of ``repro_torch.configs.ARCHS``; ``--full-config``
runs its published dims (random weights from ``--seed``), without it its
smoke config runs.
dbrx-132b's full dims (264 GB of bf16 weights) do not fit one card.
whisper-medium (encoder-decoder) needs frames: ``oneshot`` passes
``generate`` seeded stub frames.  qwen2-vl-7b's ``oneshot`` is
``generate``'s text-only route.
``--device`` defaults to ``cuda`` and the driver raises when no card is
found.  The engine modes take the attention (dense, moe) and recurrent
(rwkv6, rglru) families.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.api.serving import ServeSession
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.serve import EngineConfig, SamplingParams, run_load


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--mode", default="oneshot",
                    choices=("oneshot", "engine", "loadgen"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # engine / loadgen
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="loadgen: common prompt prefix length (prefix cache)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else smoke_config(args.arch)
    model = get_model(cfg)
    params, _ = model.init_params(seed=args.seed, device=device)
    serve = ServeSession(model=model, params=params, device=device)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, seed=args.seed)

    if args.mode == "oneshot":
        B, P = args.batch, args.prompt_len
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)
        side = {}
        if cfg.family == "encdec":
            side["frames"] = torch.randn(B, cfg.n_frames, cfg.d_model, generator=gen,
                                         device=device).to(cfg.dtype)
        out = serve.generate(prompt, max_new_tokens=args.tokens, sampling=sampling, **side)
        print(f"arch={cfg.name} device={device} batch={B} prompt={P} decoded={args.tokens}")
        print(f"prefill: {out.prefill_time * 1e3:.1f} ms; decode throughput: "
              f"{out.decode_tok_s:.1f} tok/s ({out.ms_per_step:.1f} ms/step)")
        print("sample token ids:", out.tokens[0].tolist())
        return 0

    max_len = args.max_len or (args.prompt_len + args.tokens + 8)
    engine = serve.engine(EngineConfig(max_slots=args.slots, max_len=max_len))

    if args.mode == "engine":
        rng = np.random.default_rng(args.seed)
        for _ in range(args.requests):
            prompt = rng.integers(0, cfg.vocab, size=(args.prompt_len,))
            engine.submit(prompt.tolist(), max_new_tokens=args.tokens, sampling=sampling)
        while engine.has_work():
            for ev in engine.step():
                tag = f" [{ev.finish_reason}]" if ev.done else ""
                print(f"req={ev.request_id} #{ev.index} tok={ev.token}{tag}")
        stats = engine.prefix_cache_stats
        print(f"arch={cfg.name} device={device} steps={engine.steps} "
              f"decoded={engine.tokens_decoded} prefix_hit_rate={stats.hit_rate:.3f}")
        return 0

    report = run_load(
        engine, n_requests=args.requests, prompt_len=args.prompt_len,
        max_new_tokens=args.tokens, shared_prefix_len=args.shared_prefix,
        seed=args.seed,
    )
    print(json.dumps(dict(report.to_json(), device=str(device)), indent=2))
    return 0

if __name__ == "__main__":
    sys.exit(main())
