"""Serving driver of the port: one-shot generate on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --full-config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full-config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu

``--arch`` takes any arch of ``repro_torch.configs.ARCHS`` (deepseek-7b,
qwen3-moe-30b-a3b, dbrx-132b, rwkv6-7b, recurrentgemma-2b); ``--full-config``
runs its published dims (random weights from ``--seed``), without it its
smoke config runs.
dbrx-132b's full dims (264 GB of bf16 weights) do not fit one card.
``--device`` defaults to ``cuda`` and the driver raises when no card is
found.  The engine and load generator modes come with the engine slice.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.api.serving import ServeSession
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.serve.sampling import SamplingParams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--mode", default="oneshot", choices=("oneshot",))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else smoke_config(args.arch)
    model = get_model(cfg)
    params, _ = model.init_params(seed=args.seed, device=device)
    serve = ServeSession(model=model, params=params, device=device)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, seed=args.seed)

    B, P = args.batch, args.prompt_len
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)
    out = serve.generate(prompt, max_new_tokens=args.tokens, sampling=sampling)
    print(f"arch={cfg.name} device={device} batch={B} prompt={P} decoded={args.tokens}")
    print(f"prefill: {out.prefill_time * 1e3:.1f} ms; decode throughput: "
          f"{out.decode_tok_s:.1f} tok/s ({out.ms_per_step:.1f} ms/step)")
    print("sample token ids:", out.tokens[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
