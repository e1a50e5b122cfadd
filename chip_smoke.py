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
     memory, finite losses and grad norms, and launch counters.

MoE serving (qwen3-moe-30b-a3b; the deepseek state is freed first):
  9. the MoE kernels at the path's shapes against their plain versions, with
     slot tables from ``moe_routing`` of random activations through a random
     router: the expert GEMM and the combine at the prefill shape (T 4096,
     C 384) and the decode shape (T 8, C 8), plus a capacity-overflow case
     (C 128), and the flash and decode kernels (native and int8) at qwen3's
     GQA-8 shapes (32 query heads over 4 kv heads); times and bounds as in
     phase 3, the combine's yardstick ``index_add_`` over the kept rows;
 10. both MoE smoke configs (qwen3-moe-30b-a3b, dbrx-132b) in float32: greedy
     tokens from the plain path on the CPU and the kernels on the card must be
     identical, native and int8 cache, every MoE layer through both kernels;
 11. qwen3-moe-30b-a3b at its published size (48 layers, not cut, bf16,
     random weights from seed 0): ``ServeSession.generate`` greedy at batch 8,
     prompt 512, 64 new tokens, native and int8 KV cache;
 12. profiles, after every timed run (a generate timed after the profiler ran
     measured slower decode steps): one training step per model of phases 8
     and 19 and precision, the
     decode step of phase 5, the MoE decode step of phase 11 and the
     recurrent decode steps of phase 15 (``torch.profiler``, device time by
     kind, busy ms, idle share; the MoE step split into matmul, attention,
     fused_moe, routing and other).

Recurrent serving (rwkv6-7b, recurrentgemma-2b; after the MoE state is freed):
 13. the WKV-6 and RG-LRU scan kernels at the prefill shapes (B 8, S 512;
     64 heads of 64 in bf16, lru width 2560 in f32) and at ragged smoke-size
     shapes, and the flash (S 3072, window 2048) and decode (2048-row cache,
     native and int8) kernels at recurrentgemma's 10 query heads over one kv
     head of 256, against their plain versions; times and bounds as in phase 3;
 14. both recurrent smoke configs in float32 (recurrentgemma with native and
     int8 cache, prompt 13 > its window 8): greedy tokens from the plain path
     on the CPU and the kernels on the card must be identical, through
     ``ServeSession.generate`` and through the batched route
     (``make_prefill_step`` then ``make_serve_step``); on the card the
     batched prefill's cache must equal the stepped prefill's leaf for leaf;
 15. both configs at their published size (random weights from seed 0),
     the batched route at batch 8, prompt 512, 64 greedy steps (rwkv6-7b;
     recurrentgemma-2b native and int8), and recurrentgemma-2b at prompt 3072
     (longer than its window) with 16 steps: prefill ms, decode ms/step,
     tok/s, peak memory, launches of every kernel per prefill and step;
 16. ``ServeSession.generate`` at full width (native, batch 8, prompt 512, 64
     new tokens), the reference's own recurrent route (the prompt stepped
     through ``decode_step``): its prefill ms beside the batched one; then
     the largest difference between the two routes' states, a reading, at
     prompt 128 (cut from 512 to keep the run near 5 minutes) in bf16 and
     in float32.

Recurrent training (``launch/train.py``'s session, as phases 6-8):
 17. the path's kernels at its full-width shapes against their plain
     versions: the WKV-6 scan, float and int8 r/k/v (60 rows, seq 256, 64
     heads of 64, bf16), the RG-LRU scan, float and int8 x, bit for bit (60
     rows, seq 128, width 2560, f32), the quantizer at rows of 2560 bit for
     bit, flash attention with float and int8 K/V at D = 256 (10 query heads
     over one kv head, window 2048) and at D = 32, each also at a ragged
     smoke-size shape; then the gradients of ``ops.rwkv6_scan``,
     ``rwkv6_scan_q8``, ``rglru_scan``, ``rglru_scan_q8`` and
     ``flash_attention_q8`` (D = 256) on the card against the plain ops'
     autograd gradients, for every input, at 4 rows; times and bounds as in
     phase 3;
 18. both recurrent smoke configs in float32, as phase 7: ``Session.run`` for
     6 steps on the CPU and on the card in ``f32`` and ``int8-fused``;
     per-step losses agree, and the launch counters show every scan and
     attention call (the remat recompute included) went through its kernel;
 19. rwkv6-7b (8 of 32 layers, seq 256) and recurrentgemma-2b (26 layers,
     seq 128) at full width: ``Session.run`` for 5 steps in ``f32`` and
     ``int8-fused``, reported as phase 8.  Phase 12 profiles one step of
     each.

Each record of the kernels line carries the main path (``serving``,
``training``, ``moe_serving``, ``recurrent_serving`` or
``recurrent_training``) whose shapes it was
timed at and whose launches it counts, and a ``shape`` where one path times a
kernel at two or where its shape is not the path's first.
The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Without a card, or without the port's
sources beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import shutil
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
MOE_KERNELS = ("moe_gate_up_kernel", "moe_down_kernel", "moe_invert_kernel",
               "moe_combine_kernel")
# the MoE routing's top-k, stable sort, slot scatters, count scan and softmax
# (its elementwise ops fall in "other")
ROUTING_KERNELS = ("sort", "topk", "scan", "scatter", "softmax")


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


def build_report(log: str):
    """One line per source and per compiled kernel (nvcc's ``-Xptxas -v``
    log): the kernel, its registers and its spill stores."""
    lines, name, spill = [], "?", "?"
    for line in log.splitlines():
        if line.startswith("=="):
            lines.append(line.strip())
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            lines.append(f"{name}: {m.group(1)} registers, {spill} bytes spill stores")
    mangled = sorted({w for ln in lines for w in re.findall(r"_Z\w+", ln)})
    if mangled and shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        short = (n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                 for n in plain)
        names = dict(zip(mangled, short))
        lines = [re.sub(r"_Z\w+", lambda m: names.get(m.group(0), m.group(0)), ln)
                 for ln in lines]
    return lines


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
    """Phase 12, serving: the decode step of phase 5."""
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


def profile_decode(torch, model, params, cache, logits, pos0, steps=6, moe=False):
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
    return device_time_by_kind(torch, prof, steps, "decode step", moe)


def device_time_by_kind(torch, prof, steps, what, moe=False):
    """Print device ms per step by kind of kernel; return device-busy ms per
    step (union of device spans), or None when the profiler saw none.  A MoE
    step also splits out its routing kernels."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("[profile] not measured: the profiler saw no device activity")
        return None
    kinds = {}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        low = name.lower()
        kind = ("flash_attention" if "flash_fwd" in name else
                "decode_attention" if "decode_kernel" in name else
                "quantize" if "quantize_rows_kernel" in name else
                "wkv6_scan" if "wkv6_kernel" in name else
                "rglru_scan" if "rglru_kernel" in name else
                "fused_moe" if any(w in name for w in MOE_KERNELS) else
                "matmul" if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet")) else
                "routing" if moe and any(w in low for w in ROUTING_KERNELS) else
                "other")
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


def expected_train_launches(cfg, prec, steps):
    """Kernel launches of ``steps`` training steps of ``cfg`` under ``prec``
    with remat (each layer's forward runs twice: the forward and its
    recompute in the backward): every attention layer through the flash
    kernel, every recurrent layer through its scan, and under int8-fused the
    row quantizer for K and V, for r, k and v, or for the RG-LRU input."""
    if cfg.family == "rglru":
        kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    else:
        kinds = ["W" if cfg.family == "rwkv6" else "A"] * cfg.n_layers
    q8 = prec == "int8-fused"
    kernel = {"A": "flash_attention", "R": "rglru_scan", "W": "rwkv6_scan"}
    quantized_rows = {"A": 2, "R": 1, "W": 3}        # K, V; x; r, k, v
    out = {}
    for kind in kinds:
        name = kernel[kind] + ("_q8" if q8 else "")
        out[name] = out.get(name, 0) + 2 * steps
        if q8:
            out["quantize_int8"] = out.get("quantize_int8", 0) + 2 * steps * quantized_rows[kind]
    return out


def cross_device_train(torch, ops, train_session_factory, dev, arch="deepseek-7b"):
    """Phases 7 and 18: a smoke config in f32, Session.run on the CPU (plain
    versions) vs on the card (kernels), from the same weights."""
    import copy

    rtol = {"f32": 1e-4, "int8-fused": 1e-2}   # f32 reassociation; int8 rounding flips
    steps = 6
    for prec in ("f32", "int8-fused"):
        kw = dict(arch=arch, steps=steps, seq=32, precision=prec)
        cpu = train_session_factory(device="cpu", **kw)
        params, _ = cpu.init_state()
        gpu_params = _to(copy.deepcopy(params), dev)
        want = [h["loss"] for h in cpu.run(params).history]
        gpu = train_session_factory(device=dev, **kw)
        ops.reset_launches()
        report = gpu.run(gpu_params)
        counts = dict(ops.LAUNCHES)
        got = [h["loss"] for h in report.history]
        print(f"[cross-device] train {arch} {prec}: cpu={[round(x, 6) for x in want]} "
              f"gpu={[round(x, 6) for x in got]} launches={counts}")
        if not np.allclose(got, want, rtol=rtol[prec], atol=0.0):
            raise AssertionError(f"{arch} {prec}: per-step losses differ between CPU and card")
        _check_launches(counts, expected_train_launches(gpu.model.cfg, prec, steps),
                        f"{arch} {prec} training")


# the full-width training cells: arch -> (layers, seq).  deepseek-7b and
# rwkv6-7b are cut to 8 layers (the AdamW state of the full depth does not
# fit 80 GB); recurrentgemma-2b runs all 26 at seq 128 (its 256,000-entry
# vocabulary makes the logits the largest tensors of a step)
TRAIN_CELLS = {"deepseek-7b": (8, 256), "rwkv6-7b": (8, 256), "recurrentgemma-2b": (26, 128)}


def full_width_train(torch, ops, train_session_factory, get_config, dev, arch="deepseek-7b"):
    """Phases 8 and 19: ``arch`` at full width, depth and seq from
    TRAIN_CELLS, through Session.run for 5 steps in f32 and int8-fused."""
    steps = 5
    layers, seq = TRAIN_CELLS[arch]
    totals = {name: 0 for name in ops.LAUNCHES}
    step_ms = {}
    for prec in ("f32", "int8-fused"):
        session = train_session_factory(arch=arch, device=dev, full_config=True,
                                        n_layers=layers, seq=seq, steps=steps, precision=prec)
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
        print(f"[train] {cfg.name} {prec}: {cfg.n_layers} of {get_config(arch).n_layers} "
              f"layers, d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params "
              f"({str(cfg.dtype)}), rows {sched.global_rows} ({sched.valid_rows} valid) x seq "
              f"{seq}")
        print(f"[train] {cfg.name} {prec}: {ms:.3f} ms/step (median of steps 2-{steps}), "
              f"{valid_tok_s:.1f} valid tok/s, first step {hist[0]['step_time'] * 1e3:.1f} ms, "
              f"peak memory {peak / 2**30:.3f} GiB, launches {counts}")
        print(f"[train] {cfg.name} {prec}: whole loop {report.wall_time * 1e3:.1f} ms for "
              f"{steps} steps ({loop_ms:.3f} ms/step, "
              f"{sched.valid_rows * seq / (loop_ms / 1e3):.1f} valid tok/s), of which batch "
              f"assembly {data_ms:.3f} ms/step (median of steps 2-{steps})")
        print(f"[train] {cfg.name} {prec}: losses {[round(h['loss'], 4) for h in hist]} "
              f"grad_norm {[round(h['grad_norm'], 3) for h in hist]}")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
            raise AssertionError(f"{cfg.name} {prec}: non-finite loss or grad norm")
        _check_launches(counts, expected_train_launches(cfg, prec, steps),
                        f"{cfg.name} {prec} training")
        for name, c in counts.items():
            totals[name] += c
        step_ms[(arch, prec)] = ms
        del session, report, hist
        torch.cuda.empty_cache()
    return totals, step_ms


def profile_train(torch, train_session_factory, dev, step_ms):
    """Phase 12, training: one profiled step per (arch, precision) at the
    shapes of phases 8 and 19, after a warm step, on fresh weights; then one
    more step split into its parts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.steps import loss_fn, value_and_grad

    for (arch, prec), ms in step_ms.items():
        layers, seq = TRAIN_CELLS[arch]
        session = train_session_factory(arch=arch, device=dev, full_config=True,
                                        n_layers=layers, seq=seq, steps=2, precision=prec)
        step = session.compile().step_fn
        params, opt_state = session.init_state()
        batch = session.dataset.next_device_batch(dev)
        params, opt_state, _ = step(params, opt_state, batch)        # warm
        torch.cuda.synchronize()
        batch = session.dataset.next_device_batch(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            params, opt_state, metrics = step(params, opt_state, batch)
            torch.cuda.synchronize()
        busy = device_time_by_kind(torch, prof, 1, f"{arch} {prec} train step")
        if busy is not None:
            print(f"[profile] {arch} {prec}: device busy {busy:.3f} ms of {ms:.3f} ms per "
                  f"train step: idle share {1 - busy / ms:.3f}")
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
        print(f"[profile] {arch} {prec}: one step in parts (CUDA events): forward+backward "
              f"{part[1]:.3f} ms (a forward alone {part[0]:.3f} ms), AdamW update "
              f"{part[2]:.3f} ms, grad norm {part[3]:.3f} ms")
        del session, step, params, opt_state, batch, prof, grads
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# MoE serving (qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------


def moe_kernel_checks(torch, R, F, dev):
    """Phase 9: the MoE path's kernels at its shapes against their plain
    versions on the card, slot tables from ``moe_routing``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_moe as FM
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.moe import expert_capacity

    cfg = get_config("qwen3-moe-30b-a3b")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_token
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    records = []

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf16)

    # one layer's experts and router, at the model's init scales
    wg, wu = rand(E, d, f, std=d ** -0.5), rand(E, d, f, std=d ** -0.5)
    wo = rand(E, f, d, std=f ** -0.5)
    router = torch.randn(d, E, generator=gen, device=dev) * d ** -0.5
    w_bytes = 3 * d * f * wg.element_size()                 # one expert's weights

    for label, T, C in (("prefill", 4096, expert_capacity(4096, E, k, cfg.capacity_factor)),
                        ("decode", 8, expert_capacity(8, E, k, cfg.capacity_factor)),
                        ("overflow", 4096, 128)):
        x = rand(T, d)
        slot_tok, slot_gate, _, _, keep, _ = FM.moe_routing(x, router, k, C)
        live = slot_tok[:, 0] < T
        n_live = int(live.sum())
        n_exp = int(live.view(E, C).any(dim=1).sum())     # experts holding a token
        y = FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)
        want = R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate)
        torch.cuda.synchronize()
        err = (y.float() - want.float()).abs().max().item()
        # one bf16 ulp of the largest output: both compute the same f32 value
        # up to summation order, then round once to bf16
        tol = want.float().abs().max().item() * 2.0 ** -7
        ok = math.isfinite(err) and err <= tol
        print(f"[check] fused_moe_gemm {label} T={T} C={C}: {n_live} of {E * C} slots live "
              f"({n_exp} experts), {int((~keep).sum())} copies dropped; max_abs_err="
              f"{err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_moe_gemm ({label}) disagrees with its plain version")
        out = FM.fused_moe_combine(y, slot_tok, T)
        same = torch.equal(out, R.fused_moe_combine_ref(y, slot_tok, T))
        print(f"[check] fused_moe_combine {label}: {'bit-equal' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"fused_moe_combine ({label}) differs from its plain version")
        if label == "overflow":
            continue
        esz = x.element_size()
        nbytes = n_exp * w_bytes + x.numel() * esz + y.numel() * esz + slot_tok.numel() * 8
        b_ms, b_by = bound(nbytes, 6.0 * n_live * d * f, "bfloat16")
        records.append(dict(
            name="fused_moe_gemm", path="moe_serving", shape=label, route="cuda",
            source="src/repro_torch/kernels/csrc/fused_moe.cu",
            replaces="src/repro/kernels/fused_moe.py:140",
            launches=0, max_abs_err=err,
            ms=timed_ms(lambda: FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate), flush),
            plain_ms=timed_ms(lambda: R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate),
                              flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        kept = live.nonzero()[:, 0]
        tok_kept, y_kept = slot_tok[kept, 0].long(), y[kept]
        nbytes = n_live * d * esz + T * d * esz + slot_tok.numel() * 4
        b_ms, b_by = bound(nbytes, float(n_live * d), "float32")
        records.append(dict(
            name="fused_moe_combine", path="moe_serving", shape=label, route="cuda",
            source="src/repro_torch/kernels/csrc/fused_moe.cu",
            replaces="src/repro/kernels/fused_moe.py:200",
            launches=0, max_abs_err=0.0,
            ms=timed_ms(lambda: FM.fused_moe_combine(y, slot_tok, T), flush),
            plain_ms=timed_ms(lambda: R.fused_moe_combine_ref(y, slot_tok, T), flush),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=timed_ms(lambda: torch.zeros(T, d, dtype=bf16, device=dev).index_add_(
                0, tok_kept, y_kept), flush),
        ))
        del x, slot_tok, slot_gate, keep, live, y, want, out, kept, tok_kept, y_kept
    del wg, wu, wo, router

    # -- attention at qwen3's GQA-8 shapes: 32 query heads over 4 kv heads -----
    B, S, H, Hkv, D, CACHE = 8, 512, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim(), 577
    q, kk, vv = rand(B, S, H, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)

    def check(name, got, want):
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= tol
        print(f"[check] {name} GQA-8 bf16: max_abs_err={err:.3e} tol={tol:.0e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} (GQA-8) disagrees with its plain version: {err}")
        return err

    err = check("flash_attention", flash_attention_fwd(q, kk, vv, causal=True),
                R.flash_attention_ref(q, kk, vv, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
    b_ms, b_by = bound(2 * (q.numel() + kk.numel()) * 2, 4 * D * B * H * S * (S + 1) // 2,
                       "bfloat16")
    records.append(dict(
        name="flash_attention", path="moe_serving", shape="prefill GQA-8", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:133",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: flash_attention_fwd(q, kk, vv, causal=True), flush),
        plain_ms=timed_ms(lambda: R.flash_attention_ref(q, kk, vv, causal=True), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush),
    ))
    del q, kk, vv, qt, kt, vt

    valid = torch.tensor([576, 1, 300, 513, 576, 0, 450, 520], dtype=torch.int32, device=dev)
    rows = int(valid.sum())
    q = rand(B, 1, H, D)
    kc, vc = rand(B, CACHE, Hkv, D), rand(B, CACHE, Hkv, D)
    err = check("decode_attention", decode_attention(q, kc, vc, valid),
                R.decode_attention_ref(q, kc, vc, valid))
    mask = (torch.arange(CACHE, device=dev)[None, :] < valid[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    b_ms, b_by = bound(2 * rows * Hkv * D * 2 + 2 * q.numel() * 2 + B * 4,
                       4 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention", path="moe_serving", shape="decode GQA-8", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:327",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention(q, kc, vc, valid), flush),
        plain_ms=timed_ms(lambda: R.decode_attention_ref(q, kc, vc, valid), flush),
        bound_ms=b_ms, bound_by=b_by,
        # valid_len 0 rows give NaN here (all masked); timing only
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
    ))
    kq, ks = R.quantize_int8_ref(kc)
    vq, vs = R.quantize_int8_ref(vc)
    err = check("decode_attention_int8", decode_attention_int8(q, kq, ks, vq, vs, valid),
                R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid))
    b_ms, b_by = bound(2 * rows * Hkv * (D + 4) + 2 * q.numel() * 2 + B * 4,
                       4 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention_int8", path="moe_serving", shape="decode GQA-8", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:378",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention_int8(q, kq, ks, vq, vs, valid), flush),
        plain_ms=timed_ms(lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid),
                          flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del q, kc, vc, qt, kt, vt, kq, ks, vq, vs, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def cross_device_moe(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 10: both MoE smoke configs in f32, plain path on the CPU vs
    kernels on the card, from the same weights."""
    N = 6
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 13)))
    for arch in ("qwen3-moe-30b-a3b", "dbrx-132b"):
        base = smoke_config(arch)
        for kv in ("native", "int8"):
            model = get_model(base.with_(kv_cache_dtype=kv))
            cpu_params, _ = model.init_params(seed=0, device="cpu")
            gpu_params = _to(cpu_params, dev)
            want = ServeSession(model=model, params=cpu_params, device="cpu").generate(
                prompt, max_new_tokens=N).tokens
            ops.reset_launches()
            got = ServeSession(model=model, params=gpu_params, device=dev).generate(
                prompt, max_new_tokens=N).tokens.cpu()
            counts = dict(ops.LAUNCHES)
            print(f"[cross-device] {arch} {kv}: cpu={want.tolist()} gpu={got.tolist()} "
                  f"launches={counts}")
            if not torch.equal(want, got):
                raise AssertionError(f"{arch} {kv}: greedy tokens differ between CPU and card")
            calls = (N + 1) * base.n_layers                  # prefill + N decode steps
            if counts["fused_moe_gemm"] != calls or counts["fused_moe_combine"] != calls:
                raise AssertionError(f"{arch} {kv}: MoE layers did not run through the "
                                     f"kernels: {counts}")


def full_width_moe(torch, ops, get_model, get_config, ServeSession, dev):
    """Phase 11: qwen3-moe-30b-a3b at its published size through
    ServeSession.generate."""
    B, P, N = 8, 512, 64
    cfg = get_config("qwen3-moe-30b-a3b")
    t0 = time.perf_counter()
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_experts} "
          f"experts top-{cfg.experts_per_token}, {n_params / 1e9:.3f} B params "
          f"({str(cfg.dtype)}), init {time.perf_counter() - t0:.1f} s, allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
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
        print(f"[moe] {kv}: prefill {out.prefill_time * 1e3:.3f} ms, decode "
              f"{out.decode_tok_s:.3f} tok/s ({out.ms_per_step:.3f} ms/step), peak memory "
              f"{peak / 2**30:.3f} GiB, launches {counts}")
        if tuple(toks.shape) != (B, N + 1) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"{kv}: tokens {tuple(toks.shape)} out of range")
        calls = (N + 1) * cfg.n_layers
        if (counts["fused_moe_gemm"] != calls or counts["fused_moe_combine"] != calls
                or counts["flash_attention"] != cfg.n_layers
                or counts[decode_op] != cfg.n_layers * N):
            raise AssertionError(f"{kv}: the MoE path did not run through the kernels: {counts}")
        for name, c in counts.items():
            totals[name] += c
        results[kv] = (out.ms_per_step, toks.cpu())
    agree = (results["native"][1] == results["int8"][1]).float().mean().item()
    print(f"[moe] native vs int8 KV: {agree:.3f} of generated tokens agree")
    del params
    torch.cuda.empty_cache()
    return totals, {kv: r[0] for kv, r in results.items()}


def profile_moe_serving(torch, get_model, get_config, dev, ms_per_step):
    """Phase 12, MoE serving: the decode step of phase 11."""
    B, P, N = 8, 512, 64
    cfg = get_config("qwen3-moe-30b-a3b")
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    for kv, step_ms in ms_per_step.items():
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        logits, cache = model.prefill(params, prompt, P + N + 1)
        busy = profile_decode(torch, model, params, cache, logits, P, moe=True)
        del logits, cache
        if busy is not None:
            print(f"[profile] moe {kv}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
                  f"per decode step: idle share {1 - busy / step_ms:.3f}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Recurrent serving (rwkv6-7b, recurrentgemma-2b)
# ---------------------------------------------------------------------------

RECURRENT_CASES = (("rwkv6-7b", "native"), ("recurrentgemma-2b", "native"),
                   ("recurrentgemma-2b", "int8"))


def close_check(torch, label, got, want, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` everywhere, or raise; returns
    the max abs error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.abs()).all())
    print(f"[check] {label}: max_abs_err={err:.3e} (rtol {rtol:.0e}, atol {atol:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def row_ulp_check(torch, label, got, want, ulps=2):
    """bf16 attention output against its plain version: each row (the last
    axis) within ``ulps`` bf16 ulps of that row's largest |want|, exactly 0
    where the row is all 0 (no live key).  Both sides compute in float32 and
    round once, so a 1-ulp rounding flip is the expected difference; a
    long-window row's outputs are small, so its bound is small too.  Returns
    the max abs error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    exp = torch.frexp(rowmax).exponent.float()
    bnd = torch.where(rowmax > 0, ulps * torch.exp2(exp - 8), torch.zeros_like(rowmax))
    err = diff.max().item()
    ratio = (diff / torch.where(bnd > 0, bnd, torch.ones_like(bnd))).max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= bnd).all())
    print(f"[check] {label}: max_abs_err={err:.3e}, max err/bound={ratio:.3f} "
          f"(bound {ulps} bf16 ulps of each row's max |want|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def recurrent_kernel_checks(torch, R, F, dev):
    """Phase 13: the two scan kernels and the attention kernels at the
    recurrent serving path's shapes against their plain versions on the card."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(6060)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    bf16, f32 = torch.bfloat16, torch.float32
    records = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # -- WKV-6 scan: rwkv6-7b's prefill (B 8, S 512, 64 heads of 64), and a
    #    ragged smoke-size case; w as the model makes it, exp(-exp(.)) in (0, 1)
    for label, (B, S, H, D), dtype in (("prefill", (8, 512, 64, 64), bf16),
                                       ("ragged", (2, 45, 4, 16), f32)):
        r, k, v = (randn(B, S, H, D).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, D) * 0.5)).to(dtype)
        u = randn(H, D)
        out, state = rwkv6_scan(r, k, v, w, u)
        want_out, want_state = R.rwkv6_scan_ref(r, k, v, w, u)
        torch.cuda.synchronize()
        if dtype == bf16:
            # one bf16 ulp of the largest |out|: both compute the same f32
            # value up to summation order, then round once
            atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
            err = close_check(torch, f"rwkv6_scan {label} {(B, S, H, D)} bf16 out", out,
                              want_out, 0.0, atol)
        else:
            err = close_check(torch, f"rwkv6_scan {label} {(B, S, H, D)} f32 out", out,
                              want_out, 1e-4, 1e-5)
        # the state sums terms of both signs: rtol 1e-4 plus 1e-4 of its largest |value|
        close_check(torch, f"rwkv6_scan {label} state", state, want_state, 1e-4,
                    1e-4 * want_state.abs().max().item())
        if label == "prefill":
            nbytes = 5 * r.numel() * r.element_size() + u.numel() * 4 + state.numel() * 4
            b_ms, b_by = bound(nbytes, 5.0 * D * D * B * H * S, "float32")
            records.append(dict(
                name="rwkv6_scan", path="recurrent_serving", shape=f"prefill {(B, S, H, D)}",
                route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan.py:119",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: rwkv6_scan(r, k, v, w, u), flush),
                plain_ms=timed_ms(lambda: R.rwkv6_scan_ref(r, k, v, w, u), flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ))
        del r, k, v, w, u, out, state, want_out, want_state

    # -- RG-LRU scan: recurrentgemma-2b's prefill (B 8, S 512, lru_width 2560)
    #    and a case ragged in S and W; decays in (0.5, 0.999) so the carry lives
    for label, (B, S, W) in (("prefill", (8, 512, 2560)), ("ragged", (2, 45, 300))):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
        x = randn(B, S, W)
        err = close_check(torch, f"rglru_scan {label} {(B, S, W)} f32", rglru_scan(a, x),
                          R.rglru_scan_ref(a, x), 1e-5, 1e-6)
        if label == "prefill":
            b_ms, b_by = bound(3 * x.numel() * 4, 2.0 * x.numel(), "float32")
            records.append(dict(
                name="rglru_scan", path="recurrent_serving", shape=f"prefill {(B, S, W)}",
                route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
                replaces="src/repro/kernels/rglru_scan.py:65",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: rglru_scan(a, x), flush),
                plain_ms=timed_ms(lambda: R.rglru_scan_ref(a, x), flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ))
        del a, x

    # -- attention at recurrentgemma-2b's shapes: 10 query heads over one kv
    #    head of 256 (MQA), local window 2048, a prompt longer than the window
    B, S, H, Hkv, D, WIN = 8, 3072, 10, 1, 256, 2048
    q, kk, vv = randn(B, S, H, D).to(bf16), randn(B, S, Hkv, D).to(bf16), \
        randn(B, S, Hkv, D).to(bf16)
    err = row_ulp_check(torch, f"flash_attention MQA-10 D=256 window {WIN} S={S} bf16",
                        flash_attention_fwd(q, kk, vv, causal=True, window=WIN),
                        R.flash_attention_ref(q, kk, vv, causal=True, window=WIN))
    pairs = WIN * (WIN + 1) // 2 + (S - WIN) * WIN      # live (query, key) pairs per head
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - WIN)
    b_ms, b_by = bound(2 * (q.numel() + kk.numel()) * 2, 4.0 * D * B * H * pairs, "bfloat16")
    records.append(dict(
        name="flash_attention", path="recurrent_serving",
        shape=f"prefill MQA-10 D=256 S={S} window {WIN}", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:133",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: flash_attention_fwd(q, kk, vv, causal=True, window=WIN), flush),
        plain_ms=timed_ms(lambda: R.flash_attention_ref(q, kk, vv, causal=True, window=WIN),
                          flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
    ))
    del q, kk, vv, qt, kt, vt, mask

    CACHE = WIN
    valid = torch.tensor([2048, 1, 1000, 2047, 577, 0, 1500, 2048], dtype=torch.int32,
                         device=dev)
    rows = int(valid.sum())
    q = randn(B, 1, H, D).to(bf16)
    kc, vc = randn(B, CACHE, Hkv, D).to(bf16), randn(B, CACHE, Hkv, D).to(bf16)
    err = row_ulp_check(torch, "decode_attention MQA-10 D=256 bf16",
                        decode_attention(q, kc, vc, valid),
                        R.decode_attention_ref(q, kc, vc, valid))
    amask = (torch.arange(CACHE, device=dev)[None, :] < valid[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    b_ms, b_by = bound(2 * rows * Hkv * D * 2 + 2 * q.numel() * 2 + B * 4,
                       4.0 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention", path="recurrent_serving", shape="decode MQA-10 D=256",
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:327",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention(q, kc, vc, valid), flush),
        plain_ms=timed_ms(lambda: R.decode_attention_ref(q, kc, vc, valid), flush),
        bound_ms=b_ms, bound_by=b_by,
        # valid_len 0 rows give NaN here (all masked); timing only
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, enable_gqa=True), flush),
    ))
    kq, ks = R.quantize_int8_ref(kc)
    vq, vs = R.quantize_int8_ref(vc)
    err = row_ulp_check(torch, "decode_attention_int8 MQA-10 D=256 bf16",
                        decode_attention_int8(q, kq, ks, vq, vs, valid),
                        R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid))
    b_ms, b_by = bound(2 * rows * Hkv * (D + 4) + 2 * q.numel() * 2 + B * 4,
                       4.0 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention_int8", path="recurrent_serving", shape="decode MQA-10 D=256",
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:378",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention_int8(q, kq, ks, vq, vs, valid), flush),
        plain_ms=timed_ms(lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid),
                          flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del q, kc, vc, qt, kt, vt, kq, ks, vq, vs, amask, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def serve_batched(torch, model, params, prompt, n_new, cache_len):
    """The flow of ``examples/serve_batched.py``: ``make_prefill_step`` then
    ``n_new`` greedy ``make_serve_step`` steps.  -> (tokens (B, 1 + n_new),
    prefill s, decode s), host clock after a synchronize on the card."""
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    def sync():
        if prompt.is_cuda:
            torch.cuda.synchronize(prompt.device)

    B, P = prompt.shape
    step = make_serve_step(model)
    sync()
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(model, cache_len)(params, prompt)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    sync()
    t1 = time.perf_counter()
    out = [tok]
    for t in range(n_new):
        pos = torch.full((B,), P + t, dtype=torch.int32, device=prompt.device)
        tok, _, cache = step(params, tok, cache, pos)
        out.append(tok)
    sync()
    return torch.cat(out, dim=1), t1 - t0, time.perf_counter() - t1


def _expected_launches(cfg, kv, prefills, decode_steps):
    """Launches of the recurrent path's kernels for ``prefills`` batched
    prefills and ``decode_steps`` decode steps of ``cfg``."""
    if cfg.family == "rwkv6":
        return {"rwkv6_scan": prefills * cfg.n_layers}
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    n_a = kinds.count("A")
    decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
    return {"rglru_scan": prefills * (cfg.n_layers - n_a), "flash_attention": prefills * n_a,
            decode_op: decode_steps * n_a}


def _check_launches(counts, expect, what):
    bad = {k: (counts[k], n) for k, n in expect.items() if counts[k] != n}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}: {counts}")


def _per_leaf(fn, *trees, prefix=""):
    """``{"A/k": fn(leaf of each tree), ...}`` over nested dicts of tensors."""
    if isinstance(trees[0], dict):
        out = {}
        for k in trees[0]:
            out.update(_per_leaf(fn, *(t[k] for t in trees), prefix=f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: fn(*trees)}


def _cache_diff(a, b):
    """Largest |a - b| per cache leaf."""
    return _per_leaf(lambda x, y: (x.float() - y.float()).abs().max().item(), a, b)


def cross_device_recurrent(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 14: both recurrent smoke configs in f32, the plain path on the CPU
    vs the kernels on the card, through ServeSession.generate and through the
    batched route; on the card, the batched prefill's cache against the
    stepped prefill's."""
    B, P, N = 2, 13, 6                  # prompt 13 > recurrentgemma's window 8
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, P)))
    gprompt = prompt.to(dev)
    for arch, kv in RECURRENT_CASES:
        cfg = smoke_config(arch).with_(kv_cache_dtype=kv)
        model = get_model(cfg)
        cpu_params, _ = model.init_params(seed=0, device="cpu")
        gpu_params = _to(cpu_params, dev)
        serve = ServeSession(model=model, params=gpu_params, device=dev)
        want = ServeSession(model=model, params=cpu_params, device="cpu").generate(
            prompt, max_new_tokens=N).tokens
        ops.reset_launches()
        got = serve.generate(gprompt, max_new_tokens=N).tokens.cpu()
        counts = dict(ops.LAUNCHES)
        print(f"[cross-device] {arch} {kv} generate: cpu={want.tolist()} gpu={got.tolist()} "
              f"launches={counts}")
        if not torch.equal(want, got):
            raise AssertionError(f"{arch} {kv}: generate tokens differ between CPU and card")
        expect = {k: 0 for k in ("rwkv6_scan", "rglru_scan", "flash_attention")}
        expect.update({k: n for k, n in _expected_launches(cfg, kv, 0, P + N).items() if n})
        _check_launches(counts, expect, f"{arch} {kv} generate")

        cache_len = P + N + 1
        want_b = serve_batched(torch, model, cpu_params, prompt, N, cache_len)[0]
        ops.reset_launches()
        got_b = serve_batched(torch, model, gpu_params, gprompt, N, cache_len)[0].cpu()
        counts = dict(ops.LAUNCHES)
        print(f"[cross-device] {arch} {kv} batched: cpu={want_b.tolist()} gpu={got_b.tolist()} "
              f"launches={counts}")
        if not torch.equal(want_b, got_b):
            raise AssertionError(f"{arch} {kv}: batched-route tokens differ between CPU and card")
        _check_launches(counts, _expected_launches(cfg, kv, 1, N), f"{arch} {kv} batched")

        _, batched = model.prefill(gpu_params, gprompt, cache_len)
        _, stepped = serve._prefill_recurrent(gprompt, cache_len)
        diff = _cache_diff(batched, stepped)
        # int8 cache bytes: K/V from a batched and a one-row matmul may fall
        # on either side of a rounding tie, so 1 LSB
        bad = {k: d for k, d in diff.items()
               if not d <= (1.0 if k in ("A/k", "A/v") and kv == "int8" else 1e-3)}
        print(f"[cross-device] {arch} {kv}: batched vs stepped prefill cache, max |diff| per "
              f"leaf {diff} {'ok' if not bad else 'FAIL'}")
        if bad:
            raise AssertionError(f"{arch} {kv}: batched and stepped prefill caches differ: {bad}")


def full_width_recurrent(torch, ops, get_model, get_config, ServeSession, dev):
    """Phases 15-16 (and the full-width half of 14's comparison): both
    recurrent configs at their published size, random weights from seed 0."""
    B, P, N = 8, 512, 64
    P_LONG, N_LONG = 3072, 16
    P_STATE = 128
    totals = {name: 0 for name in ops.LAUNCHES}
    decode_ms = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def run(model, cfg, kv, params, prompt, n_new, what):
        P_ = prompt.shape[1]
        # the first prefill at this shape, timed apart and checked: it holds
        # the one-time costs (allocator growth, first launches at new shapes)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, P_ + n_new + 1)
        torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0
        if tuple(logits.shape) != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} {kv} {what}: prefill logits not finite")
        del logits, cache
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        toks, pre_s, dec_s = serve_batched(torch, model, params, prompt, n_new, P_ + n_new + 1)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        ms_step = dec_s / n_new * 1e3
        print(f"[recurrent] {cfg.name} {kv} {what}: batch {B}, prompt {P_}: prefill "
              f"{pre_s * 1e3:.3f} ms (the first at this shape {first_s * 1e3:.3f} ms), "
              f"decode {ms_step:.3f} ms/step "
              f"({n_new * B / dec_s:.3f} tok/s), peak memory {peak / 2**30:.3f} GiB, "
              f"launches {counts}")
        if (tuple(toks.shape) != (B, n_new + 1) or int(toks.min()) < 0
                or int(toks.max()) >= cfg.vocab):
            raise AssertionError(f"{cfg.name} {kv}: tokens {tuple(toks.shape)} out of range")
        _check_launches(counts, _expected_launches(cfg, kv, 1, n_new), f"{cfg.name} {kv} {what}")
        for name, c in counts.items():
            totals[name] += c
        return pre_s, ms_step

    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params, _ = get_model(cfg).init_params(seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"[recurrent] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{n_params / 1e9:.3f} B params ({str(cfg.dtype)}), init "
              f"{time.perf_counter() - t0:.1f} s")
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
        batched_prefill_s = {}
        for a, kv in RECURRENT_CASES:
            if a != arch:
                continue
            model = get_model(cfg.with_(kv_cache_dtype=kv))
            batched_prefill_s[kv], decode_ms[(arch, kv)] = run(
                model, cfg, kv, params, prompt, N, "batched route")

        model = get_model(cfg)
        if cfg.family == "rglru":
            # phase 15: a prompt longer than the window: the rotating cache
            # from the first decode step, the windowed flash with tile skips
            long_prompt = torch.randint(0, cfg.vocab, (B, P_LONG), generator=gen, device=dev)
            run(model, cfg, "native", params, long_prompt, N_LONG,
                f"prompt {P_LONG} > window {cfg.window}")
            del long_prompt

        # phase 16: the reference's own recurrent route, the prompt stepped
        # through decode_step
        serve = ServeSession(model=model, params=params, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        out = serve.generate(prompt, max_new_tokens=N)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        expect = {k: 0 for k in ("rwkv6_scan", "rglru_scan", "flash_attention")}
        expect.update({k: n for k, n in _expected_launches(cfg, "native", 0, P + N).items() if n})
        _check_launches(counts, expect, f"{arch} generate")
        for name, c in counts.items():
            totals[name] += c
        print(f"[recurrent] {cfg.name} native ServeSession.generate: prefill (prompt stepped "
              f"through decode_step) {out.prefill_time * 1e3:.3f} ms vs batched prefill "
              f"{batched_prefill_s['native'] * 1e3:.3f} ms; decode {out.ms_per_step:.3f} ms/step "
              f"({out.decode_tok_s:.3f} tok/s), peak memory {peak / 2**30:.3f} GiB, "
              f"launches {counts}")
        # the two routes' states, a reading: the prompt cut to P_STATE (512
        # stepped decode steps more would double the phase), in bf16 and in
        # float32, where rounding does not pile up through the layers
        short = prompt[:, :P_STATE]
        for dtype in dict.fromkeys((cfg.dtype, torch.float32)):
            if dtype != cfg.dtype:
                del params, serve
                torch.cuda.empty_cache()
                model = get_model(cfg.with_(dtype=dtype))
                params, _ = model.init_params(seed=0, device=dev)
                serve = ServeSession(model=model, params=params, device=dev)
            _, batched = model.prefill(params, short, P_STATE + 1)
            _, stepped = serve._prefill_recurrent(short, P_STATE + 1)
            print(f"[recurrent] {cfg.name}: batched vs stepped prefill state, prompt {P_STATE}, "
                  f"{str(dtype).split('.')[-1]} (a reading): max |diff| per leaf "
                  f"{_cache_diff(batched, stepped)}, max |value| per leaf "
                  f"{_per_leaf(lambda x: x.float().abs().max().item(), stepped)}")
            del batched, stepped
        del params, model, serve, out, prompt, short
        torch.cuda.empty_cache()
    return totals, decode_ms


def profile_recurrent_serving(torch, get_model, get_config, dev, ms_per_step):
    """Phase 12, recurrent serving: the decode step of phase 15's batched route."""
    B, P, N = 8, 512, 64
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        params, _ = get_model(cfg).init_params(seed=0, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
        for (a, kv), step_ms in ms_per_step.items():
            if a != arch:
                continue
            model = get_model(cfg.with_(kv_cache_dtype=kv))
            logits, cache = model.prefill(params, prompt, P + N + 1)
            busy = profile_decode(torch, model, params, cache, logits, P)
            del logits, cache
            if busy is not None:
                print(f"[profile] {arch} {kv}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
                      f"per decode step: idle share {1 - busy / step_ms:.3f}")
        del params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Recurrent training (rwkv6-7b, recurrentgemma-2b)
# ---------------------------------------------------------------------------


def grad_check(torch, label, got, want, share):
    """Each gradient within ``share`` of its largest |want|, or raise."""
    for name, g, w in zip(label[1], got, want):
        if g.dtype != w.dtype:
            raise AssertionError(f"{label[0]} d{name}: dtype {g.dtype} != {w.dtype}")
        close_check(torch, f"{label[0]} d{name} ({str(g.dtype).split('.')[-1]})", g, w, 0.0,
                    share * w.float().abs().max().item())


def recurrent_train_kernel_checks(torch, ops, R, F, dev):
    """Phase 17: the recurrent training path's kernels at its full-width
    shapes (and ragged smoke-size ones) against their plain versions on the
    card, and the gradients of its differentiable ops against the plain
    ops' gradients."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_int8
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_int8

    gen = torch.Generator(device=dev)
    gen.manual_seed(7070)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    bf16, f32 = torch.bfloat16, torch.float32
    records = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def q8(x):
        """The training quantizer's int8 and scales over the last axis."""
        q, s = quantize_rows(x.reshape(-1, x.shape[-1]), 0.5)
        return q.view(x.shape), s.view(x.shape[:-1] + (1,))

    def deq(q, s):
        return R.dequantize_int8_ref(q, s)

    def record(name, shape, source, replaces, err, kernel, plain, nbytes, flops, dtype,
               library=None):
        b_ms, b_by = bound(nbytes, flops, dtype)
        records.append(dict(
            name=name, path="recurrent_training", shape=shape, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=f"src/repro/kernels/{replaces}", launches=0, max_abs_err=err,
            ms=timed_ms(kernel, flush), plain_ms=timed_ms(plain, flush),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if library is None else timed_ms(library, flush)))

    # -- WKV-6, float and int8: rwkv6-7b's training shape (60 rows, seq 256,
    #    64 heads of 64, bf16) and a ragged smoke-size one (f32)
    for label, (B, S, H, D), dtype in (("train", (60, 256, 64, 64), bf16),
                                       ("ragged", (2, 45, 4, 16), f32)):
        r, k, v = (randn(B, S, H, D).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, D) * 0.5)).to(dtype)
        u = randn(H, D)
        (rq, rs), (kq, ks), (vq, vs) = q8(r), q8(k), q8(v)
        rd, kd, vd = deq(rq, rs), deq(kq, ks), deq(vq, vs)
        ops_ = 5.0 * D * D * B * H * S
        for name, kernel, plain in (
                ("rwkv6_scan", lambda: rwkv6_scan(r, k, v, w, u),
                 lambda: R.rwkv6_scan_ref(r, k, v, w, u)),
                ("rwkv6_scan_q8", lambda: rwkv6_scan_int8(rq, rs, kq, ks, vq, vs, w, u, dtype),
                 lambda: R.rwkv6_scan_ref(rd, kd, vd, w, u))):
            out, state = kernel()
            want_out, want_state = plain()
            want_out = want_out.to(dtype)
            torch.cuda.synchronize()
            if dtype == bf16:
                # one bf16 ulp of the largest |out|, as phase 13 bounds the float kernel
                atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
                err = close_check(torch, f"{name} {label} {(B, S, H, D)} bf16 out", out,
                                  want_out, 0.0, atol)
            else:
                err = close_check(torch, f"{name} {label} {(B, S, H, D)} f32 out", out,
                                  want_out, 1e-4, 1e-5)
            close_check(torch, f"{name} {label} state", state, want_state, 1e-4,
                        1e-4 * want_state.abs().max().item())
            if label == "train":
                act = 3 * r.numel() * (1 if name.endswith("q8") else r.element_size())
                scales = 3 * rs.numel() * 4 if name.endswith("q8") else 0
                nbytes = (act + scales + 2 * w.numel() * w.element_size() + u.numel() * 4
                          + state.numel() * 4)                    # w in, out (same dtype)
                record(name, f"train {(B, S, H, D)}", "rwkv6_scan.cu",
                       "rwkv6_scan.py:171" if name.endswith("q8") else "rwkv6_scan.py:119",
                       err, kernel, plain, nbytes, ops_, "float32")
            del out, state, want_out, want_state
        del r, k, v, w, u, rq, rs, kq, ks, vq, vs, rd, kd, vd

    # -- RG-LRU, float and int8: recurrentgemma-2b's training shape (60 rows,
    #    seq 128, lru width 2560, f32 gates) and a ragged one; bit for bit,
    #    and the quantizer at rows of 2560 bit for bit too
    for label, (B, S, W) in (("train", (60, 128, 2560)), ("ragged", (2, 45, 300))):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
        x = randn(B, S, W)
        xq, xs = q8(x)
        want_q, want_s = R.quantize_int8_ref(x, 0.5)
        same = torch.equal(xq, want_q) and torch.equal(xs, want_s)
        print(f"[check] quantize_int8 rows of {W} f32 {tuple(x.shape)}: "
              f"{'bit-equal' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"quantize_int8 differs from its plain version at width {W}")
        xd = deq(xq, xs)
        for name, kernel, plain in (("rglru_scan", lambda: rglru_scan(a, x),
                                     lambda: R.rglru_scan_ref(a, x)),
                                    ("rglru_scan_q8", lambda: rglru_scan_int8(a, xq, xs),
                                     lambda: R.rglru_scan_ref(a, xd))):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"[check] {name} {label} {(B, S, W)} f32: "
                  f"{'bit-equal' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"{name} ({label}) differs from its plain version")
            if label == "train":
                x_bytes = xq.numel() + xs.numel() * 4 if name.endswith("q8") else x.numel() * 4
                record(name, f"train {(B, S, W)}", "rglru_scan.cu",
                       "rglru_scan.py:103" if name.endswith("q8") else "rglru_scan.py:65",
                       0.0, kernel, plain, 2 * a.numel() * 4 + x_bytes, 2.0 * x.numel(),
                       "float32")
        if label == "train":
            rows = x.view(-1, W)
            record("quantize_int8", f"RG-LRU rows {tuple(rows.shape)} f32", "quantize.cu",
                   "quantize.py:38", 0.0, lambda: quantize_rows(rows, 0.5),
                   lambda: R.quantize_int8_ref(rows, 0.5),
                   rows.numel() * 5 + rows.shape[0] * 4, 0.0, "float32")
        del a, x, xq, xs, xd, want_q, want_s

    # -- flash attention, float and int8 K/V, at recurrentgemma's head dims:
    #    D = 256 at its training shape (60 rows, seq 128, 10 query heads over
    #    one kv head, window 2048), D = 32 at its smoke shape (window 8)
    for label, (B, S, H, Hkv, D, WIN), dtype in (
            ("train", (60, 128, 10, 1, 256, 2048), bf16),
            ("smoke", (2, 13, 2, 1, 32, 8), f32)):
        q, kk, vv = randn(B, S, H, D).to(dtype), randn(B, S, Hkv, D).to(dtype), \
            randn(B, S, Hkv, D).to(dtype)
        (kq, ks), (vq, vs) = q8(kk), q8(vv)
        kd, vd = deq(kq, ks), deq(vq, vs)
        pairs = sum(min(i + 1, WIN) for i in range(S))    # live (query, key) pairs per head
        flops = 4.0 * D * B * H * pairs
        for name, kernel, plain in (
                ("flash_attention",
                 lambda: flash_attention_fwd(q, kk, vv, causal=True, window=WIN),
                 lambda: R.flash_attention_ref(q, kk, vv, causal=True, window=WIN)),
                ("flash_attention_q8",
                 lambda: flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=True, window=WIN),
                 lambda: R.flash_attention_ref(q, kd, vd, causal=True, window=WIN))):
            tag = f"{name} MQA-{H} D={D} S={S} window {WIN} {str(dtype).split('.')[-1]}"
            if dtype == bf16:
                err = row_ulp_check(torch, tag, kernel(), plain())
            else:
                err = close_check(torch, tag, kernel(), plain(), 1e-4, 1e-5)
            if label == "train":
                kv_bytes = (kq.numel() * 2 + ks.numel() * 8 if name.endswith("q8")
                            else 2 * kk.numel() * kk.element_size())
                qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
                library = None if name.endswith("q8") else (
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                           enable_gqa=True))
                record(name, f"train MQA-{H} D={D} S={S}", "flash_attention.cu",
                       "flash_attention.py:200" if name.endswith("q8")
                       else "flash_attention.py:133",
                       err, kernel, plain, 2 * q.numel() * q.element_size() + kv_bytes, flops,
                       "bfloat16", library)
                del qt, kt, vt
        del q, kk, vv, kq, ks, vq, vs, kd, vd

    # -- gradients: each differentiable op of the path with its kernel (on
    #    the card) against the plain op's autograd gradients; the int8-fused
    #    ops' gradients are the plain op's at the dequantized inputs (the
    #    reference's straight-through vjp), cast to the inputs' dtypes.
    #    Batch cut to 4 rows (the plain WKV's autograd keeps ~3 (B, H, D, D)
    #    f32 tensors per step); every other axis as in training.
    def grads_of(fn, inputs, cots):
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(loss, leaves)

    B = 4
    r, k, v = (randn(B, 256, 64, 64).to(bf16) for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, 256, 64, 64) * 0.5)).to(bf16)
    u = randn(64, 64)
    cots = (randn(B, 256, 64, 64), randn(B, 64, 64, 64))
    rd, kd, vd = (deq(*q8(t)) for t in (r, k, v))
    grad_check(torch, ("ops.rwkv6_scan", "rkvwu"),
               grads_of(ops.rwkv6_scan, (r, k, v, w, u), cots),
               grads_of(R.rwkv6_scan_ref, (r, k, v, w, u), cots), 2 ** -7)
    # the reference's vjp: of the plain scan with its output cast to r's dtype
    want = grads_of(lambda *a: (lambda o, st: (o.to(bf16), st))(*R.rwkv6_scan_ref(*a)),
                    (rd, kd, vd, w, u), cots)
    want = [g.to(t.dtype) for g, t in zip(want, (r, k, v, w, u))]
    grad_check(torch, ("ops.rwkv6_scan_q8", "rkvwu"),
               grads_of(ops.rwkv6_scan_q8, (r, k, v, w, u), cots), want, 2 ** -7)
    del r, k, v, w, u, cots, rd, kd, vd, want

    a = torch.rand(B, 128, 2560, generator=gen, device=dev) * 0.499 + 0.5
    x = randn(B, 128, 2560)
    cot = (randn(B, 128, 2560),)
    grad_check(torch, ("ops.rglru_scan", "ax"), grads_of(ops.rglru_scan, (a, x), cot),
               grads_of(R.rglru_scan_ref, (a, x), cot), 1e-5)
    grad_check(torch, ("ops.rglru_scan_q8", "ax"), grads_of(ops.rglru_scan_q8, (a, x), cot),
               grads_of(R.rglru_scan_ref, (a, deq(*q8(x))), cot), 1e-5)
    del a, x, cot

    q, kk, vv = randn(B, 128, 10, 256).to(bf16), randn(B, 128, 1, 256).to(bf16), \
        randn(B, 128, 1, 256).to(bf16)
    cot = (randn(B, 128, 10, 256),)
    kd, vd = deq(*q8(kk)), deq(*q8(vv))
    want = grads_of(lambda *t: R.flash_attention_ref(*t, causal=True, window=2048),
                    (q, kd, vd), cot)
    grad_check(torch, ("ops.flash_attention_q8 D=256", "qkv"),
               grads_of(lambda *t: ops.flash_attention_q8(*t, causal=True, window=2048),
                        (q, kk, vv), cot), [g.to(bf16) for g in want], 2 ** -7)
    del q, kk, vv, cot, kd, vd, want, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


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
    for line in build_report(_build.KERNELS.build_log):
        print(f"[build] {line}")

    records = kernel_checks(torch, ops, R, F, dev)
    records += train_kernel_checks(torch, ops, R, F, dev)
    cross_device(torch, ops, get_model, smoke_config, ServeSession, dev)
    cross_device_train(torch, ops, train_session_factory, dev)
    # the main paths: counts are reset before and read after each run
    serve_totals, decode_ms = full_width(torch, ops, get_model, get_config, ServeSession, dev)
    train_totals, train_ms = full_width_train(torch, ops, train_session_factory, get_config,
                                              dev)
    # MoE serving: the dense model's state is gone with its phases' locals
    torch.cuda.empty_cache()
    print(f"[moe] before the MoE phases: {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB "
          f"allocated")
    records += moe_kernel_checks(torch, R, F, dev)
    cross_device_moe(torch, ops, get_model, smoke_config, ServeSession, dev)
    moe_totals, moe_ms = full_width_moe(torch, ops, get_model, get_config, ServeSession, dev)
    # recurrent serving, after the MoE state is freed
    records += recurrent_kernel_checks(torch, R, F, dev)
    cross_device_recurrent(torch, ops, get_model, smoke_config, ServeSession, dev)
    rec_totals, rec_ms = full_width_recurrent(torch, ops, get_model, get_config, ServeSession,
                                              dev)
    # recurrent training
    records += recurrent_train_kernel_checks(torch, ops, R, F, dev)
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cross_device_train(torch, ops, train_session_factory, dev, arch)
    rec_train_totals = {name: 0 for name in ops.LAUNCHES}
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        totals, ms = full_width_train(torch, ops, train_session_factory, get_config, dev, arch)
        train_ms.update(ms)
        for name, c in totals.items():
            rec_train_totals[name] += c
    # profiles after every timed run: a generate timed after the profiler ran
    # measured slower decode steps
    profile_train(torch, train_session_factory, dev, train_ms)
    profile_serving(torch, get_model, get_config, dev, decode_ms)
    profile_moe_serving(torch, get_model, get_config, dev, moe_ms)
    profile_recurrent_serving(torch, get_model, get_config, dev, rec_ms)
    totals = {"serving": serve_totals, "training": train_totals, "moe_serving": moe_totals,
              "recurrent_serving": rec_totals, "recurrent_training": rec_train_totals}
    for rec in records:
        rec["launches"] = totals[rec["path"]][rec["name"]]
        print(f"[launches] {rec['name']} on the {rec['path']} path: {rec['launches']}"
              + (f" (timed at the {rec['shape']} shape)" if "shape" in rec else ""))
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} never launched on the {rec['path']} path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card_line())                    # again, beside the numbers at the end
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
