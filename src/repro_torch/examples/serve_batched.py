"""Batched serving example: prefill + KV-cache decode across architectures,
including the recurrent (O(1)-state) families (port of
``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch whisper-medium --device cpu

The smoke config of ``--arch`` with random weights from seed 0; the prompt
(and whisper's frames, qwen2-vl's 4 patch embeddings) drawn with numpy from
the same seed.  One ``Model.prefill`` over the prompt, then ``--tokens``
greedy steps of the serve step (``train.steps.make_serve_step``).  A VLM's
decode positions count from its patches + prompt, so its cache holds those
rows too (the reference sizes it at prompt + tokens + 1 and its last writes
clamp to the cache's last row).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.api import Model, get_model
from repro_torch.train.steps import make_serve_step

N_PATCHES = 4        # the reference example's stub patch embeddings


def side_inputs(model: Model, batch: int, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Whisper's frames or the VLM's patch embeddings (standard normal, in
    the model's dtype); none for the text-only families."""
    cfg, rng = model.cfg, np.random.default_rng(seed + 1)
    if cfg.family == "encdec":
        shape, key = (batch, cfg.n_frames, cfg.d_model), "frames"
    elif cfg.family == "vlm":
        shape, key = (batch, N_PATCHES, cfg.d_model), "patch_embeds"
    else:
        return {}
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return {key: x.to(device=device, dtype=cfg.dtype)}


def generate_batched(model: Model, params, prompt: torch.Tensor, n_new: int,
                     cache_len: Optional[int] = None,
                     **side: torch.Tensor) -> Tuple[torch.Tensor, float, float]:
    """``Model.prefill`` over ``prompt`` (B, P), then ``n_new`` greedy serve
    steps.  -> (tokens (B, 1 + n_new) int32, prefill s, decode s), host
    clock, after a device sync on a card."""
    B, P = prompt.shape
    n_vis = side["patch_embeds"].shape[1] if "patch_embeds" in side else 0
    cache_len = cache_len or n_vis + P + n_new + 1

    def sync():
        if prompt.is_cuda:
            torch.cuda.synchronize(prompt.device)

    serve = make_serve_step(model)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, cache_len, **side)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        sync()
        t1 = time.perf_counter()
        out = [tok]
        for t in range(n_new):
            pos = torch.full((B,), n_vis + P + t, dtype=torch.int32, device=prompt.device)
            tok, _, cache = serve(params, tok, cache, pos)
            out.append(tok)
        sync()
    return torch.cat(out, dim=1), t1 - t0, time.perf_counter() - t1


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    model = get_model(cfg)
    params, _ = model.init_params(seed=args.seed, device=dev)
    B, P, N = args.batch, args.prompt_len, args.tokens
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P), dtype=np.int32)).to(dev)
    tokens, _, dt = generate_batched(model, params, prompt, N,
                                     **side_inputs(model, B, args.seed, dev))
    print(f"{cfg.name}: decoded {N} tokens x {B} seqs in {dt:.2f}s "
          f"({N * B / dt:.0f} tok/s)")
    print("sample:", tokens[0].tolist()[:16], "...")
    return tokens


if __name__ == "__main__":
    main()
