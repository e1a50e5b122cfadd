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

Training (``repro_torch.launch.train``'s session: the demo fleet of 1 host
+ 2 CSD-class workers, tuned to 60 rows of which 24 are valid, AdamW, the
goyal schedule):
  6. the training path's kernels (flash attention, row quantizer, int8-K/V
     flash attention) at the full-width training shapes (Q/K/V (60, 256, 32,
     128) bf16) against their plain versions: the quantizer bit for bit at
     noise 0.5, at random noise and at a ragged row count; times and bounds
     as in phase 3;
  7. the smoke config in float32: ``Session.run`` for 6 steps on the CPU
     (plain versions) and on the card (kernels) from the same weights, in
     ``f32`` and ``int8-fused``; per-step losses must agree;
  8. deepseek-7b at full width, depth cut 30 -> 8 layers (AdamW state of 30
     layers does not fit 80 GB), seq 256: ``Session.run`` for 5 steps in
     ``f32`` and in ``int8-fused``, with ms/step (the step alone, and the
     whole loop with the data plane's batch assembly), valid tokens/s, peak
     memory, finite losses and grad norms, and launch counters;
  9. profiles, after every timed run: one training step per precision and
     the decode step of phase 5 (``torch.profiler``, device time by kind).

Each record of the kernels line carries the main path (``serving`` or
``training``) whose shapes it was timed at and whose launches it counts;
flash attention has one record per path.  The last two lines are
``{"kernels": [...]}`` and
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
                name="flash_attention", path="serving", route="cuda",
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
                name="decode_attention", path="serving", route="cuda",
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
                name="decode_attention_int8", path="serving", route="cuda",
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
        results[kv] = (out.ms_per_step, toks.cpu())
    agree = (results["native"][1] == results["int8"][1]).float().mean().item()
    print(f"[full] native vs int8 KV: {agree:.3f} of generated tokens agree")
    return totals, {kv: r[0] for kv, r in results.items()}


def profile_serving(torch, get_model, get_config, dev, ms_per_step):
    """Phase 9, serving: the decode step of phase 5, profiled after every
    timed run (a timed generate that ran after the profiler measured slower
    decode steps)."""
    B, P, N = 8, 512, 64
    cfg = get_config("deepseek-7b")
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    for kv, step_ms in ms_per_step.items():
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        logits, cache = model.prefill(params, prompt, P + N + 1)
        busy = profile_decode(torch, model, params, cache, logits, P)
        del logits, cache
        if busy is not None:
            print(f"[profile] {kv}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
                  f"per decode step: idle share {1 - busy / step_ms:.3f}")


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
    return device_time_by_kind(torch, prof, steps, "decode step")


def device_time_by_kind(torch, prof, steps, what):
    """Print device ms per step by kind of kernel; return device-busy ms per
    step (union of device spans), or None when the profiler saw none."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("[profile] not measured: the profiler saw no device activity")
        return None
    kinds = {}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        kind = ("flash_attention" if "flash_fwd" in name else
                "decode_attention" if "decode_kernel" in name else
                "quantize" if "quantize_rows_kernel" in name else
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
    print(f"[profile] device ms per {what} by kind: {per_step}; "
          f"{len(spans) / steps:.0f} device activities per {what}")
    return busy / steps / 1e3


def train_kernel_checks(torch, ops, R, F, dev):
    """Phase 6: the training path's kernels at the full-width training shapes."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd
    from repro_torch.kernels.quantize import quantize_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    B, S, H, D = 60, 256, 32, 128                  # the tuned demo batch at seq 256
    bf16 = torch.bfloat16
    k, v, q = (torch.randn(B, S, H, D, generator=gen, device=dev).to(bf16) for _ in range(3))
    rows = k.view(-1, D)
    records = []
    tol = 2e-2                                      # bf16 output rounding
    flops = 4 * D * B * H * S * (S + 1) // 2        # causal pairs only

    # -- flash attention (the f32 / bf16 precisions' kernel), causal, MHA ------
    err = (flash_attention_fwd(q, k, v, causal=True).float()
           - R.flash_attention_ref(q, k, v, causal=True).float()).abs().max().item()
    torch.cuda.synchronize()
    ok = math.isfinite(err) and err <= tol
    print(f"[check] flash_attention bfloat16 {(B, S, H, D)}: max_abs_err={err:.3e} "
          f"tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by = bound(4 * q.numel() * q.element_size(), flops, "bfloat16")
    records.append(dict(
        name="flash_attention", path="training", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:133",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: flash_attention_fwd(q, k, v, causal=True), flush),
        plain_ms=timed_ms(lambda: R.flash_attention_ref(q, k, v, causal=True), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush),
    ))
    del qt, kt, vt

    # -- row quantizer: bit-equal to its plain version ------------------------
    cases = [("noise 0.5", rows, 0.5),
             ("random noise", rows, torch.rand(rows.shape, generator=gen, device=dev)),
             ("ragged R=1001", rows[:1001], 0.5)]
    for label, x, noise in cases:
        got, want = quantize_rows(x, noise), R.quantize_int8_ref(x, noise)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        print(f"[check] quantize_int8 {label}, {tuple(x.shape)} bf16: "
              f"{'bit-equal' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"quantize_int8 ({label}) differs from its plain version")
    del cases
    R_, N = rows.shape
    nbytes = R_ * N * rows.element_size() + R_ * N + R_ * 4     # x in, q and scales out
    b_ms, b_by = bound(nbytes, 0.0, "bfloat16")
    records.append(dict(
        name="quantize_int8", path="training", route="cuda",
        source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:38",
        launches=0, max_abs_err=0.0,
        ms=timed_ms(lambda: quantize_rows(rows, 0.5), flush),
        plain_ms=timed_ms(lambda: R.quantize_int8_ref(rows, 0.5), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # -- int8-K/V flash attention, causal, at the main path's noise 0.5 --------
    kq, ks = (t.view(B, S, H, -1) for t in quantize_rows(rows, 0.5))
    vq, vs = (t.view(B, S, H, -1) for t in quantize_rows(v.view(-1, D), 0.5))
    del k, v, rows

    def kernel():
        return flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=True)

    def plain():
        return R.flash_attention_ref(q, R.dequantize_int8_ref(kq, ks),
                                     R.dequantize_int8_ref(vq, vs), causal=True)

    err = (kernel().float() - plain().float()).abs().max().item()
    torch.cuda.synchronize()
    ok = math.isfinite(err) and err <= tol
    print(f"[check] flash_attention_q8 bfloat16: max_abs_err={err:.3e} tol={tol:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention_q8 disagrees with its plain version: {err}")
    # the op on float K/V against flash_attention_q8_ref (quantize + dequantize + attend)
    kf, vf = R.dequantize_int8_ref(kq, ks, bf16), R.dequantize_int8_ref(vq, vs, bf16)
    op_err = (ops.flash_attention_q8(q, kf, vf, causal=True).float()
              - R.flash_attention_q8_ref(q, kf, vf, causal=True).float()).abs().max().item()
    print(f"[check] ops.flash_attention_q8 vs flash_attention_q8_ref: "
          f"max_abs_err={op_err:.3e} tol={tol:.0e} {'ok' if op_err <= tol else 'FAIL'}")
    if not (math.isfinite(op_err) and op_err <= tol):
        raise AssertionError(f"ops.flash_attention_q8 disagrees with its plain version: {op_err}")
    del kf, vf
    nbytes = (2 * q.numel() * q.element_size()             # q in, out
              + kq.numel() + vq.numel() + ks.numel() * 4 + vs.numel() * 4)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    records.append(dict(
        name="flash_attention_q8", path="training", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:200",
        launches=0, max_abs_err=err,
        ms=timed_ms(kernel, flush), plain_ms=timed_ms(plain, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del q, kq, ks, vq, vs, scratch
    for rec in records:
        print(json.dumps(rec))
    return records


def cross_device_train(torch, ops, train_session_factory, dev):
    """Phase 7: smoke config in f32, Session.run on the CPU (plain versions)
    vs on the card (kernels), from the same weights."""
    import copy

    rtol = {"f32": 1e-4, "int8-fused": 1e-2}   # f32 reassociation; int8 rounding flips
    steps = 6
    for prec in ("f32", "int8-fused"):
        kw = dict(steps=steps, seq=32, precision=prec)
        cpu = train_session_factory(device="cpu", **kw)
        params, _ = cpu.init_state()
        gpu_params = _to(copy.deepcopy(params), dev)
        want = [h["loss"] for h in cpu.run(params).history]
        gpu = train_session_factory(device=dev, **kw)
        ops.reset_launches()
        report = gpu.run(gpu_params)
        counts = dict(ops.LAUNCHES)
        got = [h["loss"] for h in report.history]
        print(f"[cross-device] train {prec}: cpu={[round(x, 6) for x in want]} "
              f"gpu={[round(x, 6) for x in got]} launches={counts}")
        if not np.allclose(got, want, rtol=rtol[prec], atol=0.0):
            raise AssertionError(f"{prec}: per-step losses differ between CPU and card")
        calls = steps * gpu.model.cfg.n_layers * 2        # forward + remat recompute
        expect = ({"flash_attention": calls} if prec == "f32" else
                  {"flash_attention_q8": calls, "quantize_int8": 2 * calls})
        if any(counts[k] != n for k, n in expect.items()):
            raise AssertionError(f"{prec}: attention did not run through the kernels: {counts}")


def full_width_train(torch, ops, train_session_factory, dev):
    """Phase 8: deepseek-7b, full width, 8 layers, through Session.run."""
    steps, seq, layers = 5, 256, 8
    totals = {name: 0 for name in ops.LAUNCHES}
    step_ms = {}
    for prec in ("f32", "int8-fused"):
        session = train_session_factory(device=dev, full_config=True, n_layers=layers,
                                        seq=seq, steps=steps, precision=prec)
        cfg = session.model.cfg
        sched = session.tune().schedule
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        report = session.run()
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        hist = report.history
        ms = statistics.median(h["step_time"] for h in hist[1:]) * 1e3    # steps 2-5
        data_ms = statistics.median(h["data_time"] for h in hist[1:]) * 1e3
        valid_tok_s = sched.valid_rows * seq / (ms / 1e3)
        loop_ms = report.wall_time / steps * 1e3          # all steps, data plane included
        print(f"[train] {cfg.name} {prec}: {cfg.n_layers} of 30 layers, d_model "
              f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params ({str(cfg.dtype)}), "
              f"rows {sched.global_rows} ({sched.valid_rows} valid) x seq {seq}")
        print(f"[train] {prec}: {ms:.3f} ms/step (median of steps 2-{steps}), "
              f"{valid_tok_s:.1f} valid tok/s, first step {hist[0]['step_time'] * 1e3:.1f} ms, "
              f"peak memory {peak / 2**30:.3f} GiB, launches {counts}")
        print(f"[train] {prec}: whole loop {report.wall_time * 1e3:.1f} ms for {steps} steps "
              f"({loop_ms:.3f} ms/step, {sched.valid_rows * seq / (loop_ms / 1e3):.1f} valid "
              f"tok/s), of which batch assembly {data_ms:.3f} ms/step (median of steps 2-{steps})")
        print(f"[train] {prec}: losses {[round(h['loss'], 4) for h in hist]} grad_norm "
              f"{[round(h['grad_norm'], 3) for h in hist]}")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
            raise AssertionError(f"{prec}: non-finite loss or grad norm")
        calls = steps * layers * 2                          # forward + remat recompute
        expect = ({"flash_attention": calls} if prec == "f32" else
                  {"flash_attention_q8": calls, "quantize_int8": 2 * calls})
        if any(counts[k] != n for k, n in expect.items()):
            raise AssertionError(f"{prec}: attention did not run through the kernels: {counts}")
        for name, c in counts.items():
            totals[name] += c
        step_ms[prec] = ms
        del session, report, hist
        torch.cuda.empty_cache()
    return totals, step_ms


def profile_train(torch, train_session_factory, dev, step_ms):
    """Phase 9, training: one profiled step per precision at the phase-8
    shapes, after a warm step, on fresh weights; then one more step split
    into its parts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.steps import loss_fn, value_and_grad

    for prec, ms in step_ms.items():
        session = train_session_factory(device=dev, full_config=True, n_layers=8, seq=256,
                                        steps=2, precision=prec)
        step = session.compile().step_fn
        params, opt_state = session.init_state()
        batch = session.dataset.next_device_batch(dev)
        params, opt_state, _ = step(params, opt_state, batch)        # warm
        torch.cuda.synchronize()
        batch = session.dataset.next_device_batch(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            params, opt_state, metrics = step(params, opt_state, batch)
            torch.cuda.synchronize()
        busy = device_time_by_kind(torch, prof, 1, f"{prec} train step")
        if busy is not None:
            print(f"[profile] {prec}: device busy {busy:.3f} ms of {ms:.3f} ms per train "
                  f"step: idle share {1 - busy / ms:.3f}")
        # the parts of make_train_step's step, one after another, on CUDA events
        batch = session.dataset.next_device_batch(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        with torch.no_grad():
            loss_fn(session.model, params, batch)
        ev[1].record()
        _, grads = value_and_grad(session.model, params, batch)
        ev[2].record()
        opt_state, params = session.optimizer.update(grads, opt_state, params, metrics["lr"])
        ev[3].record()
        torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
        ev[4].record()
        torch.cuda.synchronize()
        part = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
        print(f"[profile] {prec}: one step in parts (CUDA events): forward+backward "
              f"{part[1]:.3f} ms (a forward alone {part[0]:.3f} ms), AdamW update "
              f"{part[2]:.3f} ms, grad norm {part[3]:.3f} ms")
        del session, step, params, opt_state, batch, prof, grads
        torch.cuda.empty_cache()


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
    from repro_torch.launch.train import train_session_factory
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
    records += train_kernel_checks(torch, ops, R, F, dev)
    cross_device(torch, ops, get_model, smoke_config, ServeSession, dev)
    cross_device_train(torch, ops, train_session_factory, dev)
    # the main paths: counts are reset before and read after each run
    serve_totals, decode_ms = full_width(torch, ops, get_model, get_config, ServeSession, dev)
    train_totals, train_ms = full_width_train(torch, ops, train_session_factory, dev)
    profile_train(torch, train_session_factory, dev, train_ms)
    profile_serving(torch, get_model, get_config, dev, decode_ms)
    totals = {"serving": serve_totals, "training": train_totals}
    for rec in records:
        rec["launches"] = totals[rec["path"]][rec["name"]]
        print(f"[launches] {rec['name']} on the {rec['path']} path: {rec['launches']}")
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} never launched on the {rec['path']} path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
