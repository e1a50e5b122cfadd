#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. each kernel at the serving path's shapes against its plain PyTorch
     version on the card, with its time (CUDA events, median of 25, L2
     flushed before each run), the plain version's time, the
     ``F.scaled_dot_product_attention`` yardstick where one call computes the
     same function, and the least time the card could take (bytes over
     3.35 TB/s or operations over the peak rate of their type);
  4. the smoke config in float32: greedy tokens from the plain path on the CPU
     and the kernel path on the card must be identical, native and int8 cache;
  5. deepseek-7b at its published size (30 layers, d_model 4096, bf16, random
     weights from seed 0): ``ServeSession.generate`` greedy at batch 8, prompt
     512, 64 new tokens, native and int8 KV cache, with the launch counters
     showing that every attention call went through the kernels.

The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Without a card, or without the port's
sources beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12                      # H100 SXM device memory rate
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16; f32 FMA
N_TIMED = 25


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def timed_ms(fn, flush) -> float:
    """Median device time of ``fn()`` over N_TIMED runs, L2 flushed before each."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_checks(torch, ops, R, F, dev):
    """Phase 3: every kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    B, S, H, D, CACHE = 8, 512, 32, 128, 577
    valid = torch.tensor([576, 1, 300, 513, 576, 0, 450, 520], dtype=torch.int32, device=dev)
    rows = int(valid.sum())
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # bf16 output rounding; f32 reassociation
    records = []

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def check(name, kernel, plain, dtype):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= tol[dtype]
        print(f"[check] {name} {str(dtype).split('.')[-1]}: max_abs_err={err:.3e} "
              f"tol={tol[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol[dtype]}")
        return err

    for dtype in (torch.float32, torch.bfloat16):
        # -- flash attention: prefill, causal, MHA --------------------------------
        q, k, v = (rand(B, S, H, D, dtype=dtype) for _ in range(3))
        err = check("flash_attention", lambda: flash_attention_fwd(q, k, v, causal=True),
                    lambda: R.flash_attention_ref(q, k, v, causal=True), dtype)
        if dtype == torch.bfloat16:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            flops = 4 * D * B * H * S * (S + 1) // 2
            nbytes = 4 * q.numel() * q.element_size()
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            records.append(dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:133",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: flash_attention_fwd(q, k, v, causal=True), flush),
                plain_ms=timed_ms(lambda: R.flash_attention_ref(q, k, v, causal=True), flush),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), flush),
            ))
        del q, k, v

        # -- decode attention, native cache ---------------------------------------
        q = rand(B, 1, H, D, dtype=dtype)
        kc, vc = rand(B, CACHE, H, D, dtype=dtype), rand(B, CACHE, H, D, dtype=dtype)
        err = check("decode_attention", lambda: decode_attention(q, kc, vc, valid),
                    lambda: R.decode_attention_ref(q, kc, vc, valid), dtype)
        if dtype == torch.bfloat16:
            mask = (torch.arange(CACHE, device=dev)[None, :] < valid[:, None])[:, None, None, :]
            qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
            esz = kc.element_size()
            nbytes = 2 * rows * H * D * esz + 2 * q.numel() * esz + valid.numel() * 4
            b_ms, b_by = bound(nbytes, 4 * D * H * rows, "bfloat16")
            records.append(dict(
                name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:327",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: decode_attention(q, kc, vc, valid), flush),
                plain_ms=timed_ms(lambda: R.decode_attention_ref(q, kc, vc, valid), flush),
                bound_ms=b_ms, bound_by=b_by,
                # valid_len 0 rows give NaN here (all masked); timing only
                library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), flush),
            ))

        # -- decode attention, int8 cache -----------------------------------------
        kq, ks = R.quantize_int8_ref(kc)
        vq, vs = R.quantize_int8_ref(vc)
        del kc, vc
        err = check("decode_attention_int8",
                    lambda: decode_attention_int8(q, kq, ks, vq, vs, valid),
                    lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid), dtype)
        if dtype == torch.bfloat16:
            nbytes = 2 * rows * H * (D + 4) + 2 * q.numel() * q.element_size() + valid.numel() * 4
            b_ms, b_by = bound(nbytes, 4 * D * H * rows, "bfloat16")
            records.append(dict(
                name="decode_attention_int8", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:378",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: decode_attention_int8(q, kq, ks, vq, vs, valid), flush),
                plain_ms=timed_ms(
                    lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid), flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ))
        del q, kq, ks, vq, vs
    del scratch
    for rec in records:
        print(json.dumps(rec))
    return records


def cross_device(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 4: smoke config in f32, plain path on the CPU vs kernels on the card."""
    base = smoke_config("deepseek-7b")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, base.vocab, (2, 13)))
    for kv in ("native", "int8"):
        model = get_model(base.with_(kv_cache_dtype=kv))
        cpu_params, _ = model.init_params(seed=0, device="cpu")
        gpu_params = {k: _to(v, dev) for k, v in cpu_params.items()}
        want = ServeSession(model=model, params=cpu_params, device="cpu").generate(
            prompt, max_new_tokens=6).tokens
        ops.reset_launches()
        got = ServeSession(model=model, params=gpu_params, device=dev).generate(
            prompt, max_new_tokens=6).tokens.cpu()
        counts = dict(ops.LAUNCHES)
        print(f"[cross-device] {kv}: cpu={want.tolist()} gpu={got.tolist()} launches={counts}")
        if not torch.equal(want, got):
            raise AssertionError(f"{kv}: greedy tokens differ between CPU and card")
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        if counts["flash_attention"] != base.n_layers or counts[decode_op] != 6 * base.n_layers:
            raise AssertionError(f"{kv}: attention did not run through the kernels: {counts}")


def _to(tree, dev):
    return {k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)


def full_width(torch, ops, get_model, get_config, ServeSession, dev):
    """Phase 5: deepseek-7b at its published size through ServeSession.generate."""
    B, P, N = 8, 512, 64
    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[full] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({str(cfg.dtype)}), init "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    totals = {name: 0 for name in ops.LAUNCHES}
    results = {}
    for kv in ("native", "int8"):
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        serve = ServeSession(model=model, params=params, device=dev)
        logits, cache = model.prefill(params, prompt, P + N + 1)    # warm-up + check
        torch.cuda.synchronize()
        if tuple(logits.shape) != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{kv}: prefill logits {tuple(logits.shape)} not finite")
        del logits, cache
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        out = serve.generate(prompt, max_new_tokens=N)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        toks = out.tokens
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        print(f"[full] {kv}: prefill {out.prefill_time * 1e3:.3f} ms, decode "
              f"{out.decode_tok_s:.3f} tok/s ({out.ms_per_step:.3f} ms/step), peak memory "
              f"{peak / 2**30:.3f} GiB, launches {counts}")
        if tuple(toks.shape) != (B, N + 1) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"{kv}: tokens {tuple(toks.shape)} out of range")
        if counts["flash_attention"] != cfg.n_layers or counts[decode_op] != cfg.n_layers * N:
            raise AssertionError(f"{kv}: attention did not run through the kernels: {counts}")
        for name, c in counts.items():
            totals[name] += c
        results[kv] = (model, out.ms_per_step, toks.cpu())
    # profiled last: a timed generate that ran after the profiler measured
    # slower decode steps, so no timed run follows it
    for kv, (model, ms_per_step, _) in results.items():
        logits, cache = model.prefill(params, prompt, P + N + 1)
        busy = profile_decode(torch, model, params, cache, logits, P)
        del logits, cache
        if busy is not None:
            print(f"[profile] {kv}: device busy {busy:.3f} ms of {ms_per_step:.3f} ms "
                  f"per decode step: idle share {1 - busy / ms_per_step:.3f}")
    agree = (results["native"][2] == results["int8"][2]).float().mean().item()
    print(f"[full] native vs int8 KV: {agree:.3f} of generated tokens agree")
    return totals


def profile_decode(torch, model, params, cache, logits, pos0, steps=6):
    """Device time of one decode step by kind of kernel, from torch.profiler
    over ``steps`` steps (after 2 unprofiled ones).  Returns the device-busy
    ms per step, or None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    B = tok.shape[0]

    def step(t, tok):
        pos = torch.full((B,), pos0 + t, dtype=torch.int32, device=tok.device)
        out, _ = model.decode_step(params, tok, cache, pos)
        return torch.argmax(out[:, -1], dim=-1).to(torch.int32)[:, None]

    for t in range(2):
        tok = step(t, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(2, 2 + steps):
            tok = step(t, tok)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("[profile] not measured: the profiler saw no device activity")
        return None
    kinds = {}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        kind = ("flash_attention" if "flash_fwd_kernel" in name else
                "decode_attention" if "decode_kernel" in name else
                "matmul" if any(w in name.lower() for w in ("gemm", "cutlass", "xmma", "nvjet"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start)
        if start > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    per_step = {k: round(v / steps / 1e3, 4) for k, v in sorted(kinds.items())}
    print(f"[profile] device ms per decode step by kind: {per_step}; "
          f"{len(spans) / steps:.0f} device activities per step")
    return busy / steps / 1e3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"the port's sources are not beside this script ({src / 'repro_torch'})")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    sys.path.insert(0, str(src))
    import torch.nn.functional as F

    from repro_torch.api.serving import ServeSession
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as R
    from repro_torch.models.api import get_model

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    _build.KERNELS.build()
    print(f"[build] {_build.KERNELS.build_seconds:.1f} s")
    for line in _build.KERNELS.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")

    records = kernel_checks(torch, ops, R, F, dev)
    cross_device(torch, ops, get_model, smoke_config, ServeSession, dev)
    totals = full_width(torch, ops, get_model, get_config, ServeSession, dev)
    for rec in records:
        rec["launches"] = totals[rec["name"]]
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} never launched on the main path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
