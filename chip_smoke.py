#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc):
     each kernel's registers and spill stores (``-Xptxas -v``), and the
     tensor-core instructions (HMMA, HGMMA) its SASS holds (``cuobjdump``);
     the bf16 flash kernel, the bf16-query int8-K/V flash kernel, the bf16
     MoE gate/up and down kernels (both routes) and the chunked WKV-6 kernel
     must hold some;
  3. each kernel at the serving path's shapes against its plain PyTorch
     version on the card, with its time (CUDA events, median of 25, L2
     flushed before each run), the plain version's time, the
     ``F.scaled_dot_product_attention`` yardstick where one call computes the
     same function, and the least time the card could take (bytes over
     3.35 TB/s or operations over the peak rate of their type); then the
     tiles' edges, bf16 outputs to 2 bf16 ulps of each row: flash at
     lengths 1, 63, 65, 129 (and 100, 200, 77), windows of 8 and 100, GQA-8,
     10 over 1 and head dims 16 and 32, with bf16 K/V and with int8 K/V;
     decode (native and int8) at lengths
     around the split's chunk, 0 and 1, with windows starting inside a chunk;
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
     noise 0.5, at random noise and at a ragged row count, with the route
     ``quantize_plan`` names, then at its routes' edges (rows of 16, 24, 45
     and 300, R of 1 and ragged, views with unaligned bases, zero rows,
     denormals beside a huge value, .5 ties); times and bounds as in phase 3;
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
     (C 128), each with the route it took and the GEMM's gate/up and down
     kernels timed apart (``torch.profiler``), then the routes' edges (ragged
     f and d, one token, dbrx's widths, 300 experts; the combine on both
     routes and a token past MAX_K slots), and the flash and decode kernels
     (native and int8) at qwen3's GQA-8 shapes (32 query heads over 4 kv
     heads); times and bounds as in phase 3, the combine's yardstick
     ``index_add_`` over the kept rows, the GEMM's three products as
     ``torch.bmm`` on gathered rows as a note;
 10. both MoE smoke configs (qwen3-moe-30b-a3b, dbrx-132b) in float32: greedy
     tokens from the plain path on the CPU and the kernels on the card must be
     identical, native and int8 cache, every MoE layer through both kernels;
 11. qwen3-moe-30b-a3b at its published size (48 layers, not cut, bf16,
     random weights from seed 0): ``ServeSession.generate`` greedy at batch 8,
     prompt 512, 64 new tokens, native and int8 KV cache;
 12. profiles, after every timed run (a generate timed after the profiler ran
     measured slower decode steps): one training step per model of phases 8
     and 19 and precision, the
     decode step of phase 5, the MoE decode step of phase 11, the
     recurrent decode steps of phase 15 and a decode-only engine step of
     phase 22's cell (8 requests in 8 slots, native KV)
     (``torch.profiler``, device time by kind, busy ms, idle share; the MoE
     step split into matmul, attention, fused_moe, routing and other).

Recurrent serving (rwkv6-7b, recurrentgemma-2b; after the MoE state is freed):
 13. the WKV-6 and RG-LRU scan kernels at the prefill shapes (B 8, S 512;
     64 heads of 64 in bf16, lru width 2560 in f32) and at ragged smoke-size
     shapes, and the flash (S 3072, window 2048) and decode (2048-row cache,
     native and int8) kernels at recurrentgemma's 10 query heads over one kv
     head of 256, against their plain versions (the RG-LRU scan bit for
     bit); times and bounds as in phase 3; then WKV-6 cases of their own
     (bf16 at S 45 and 300, not multiples of the chunked kernel's 16 steps,
     bf16 at head dim 16, decays near 1e-30 and near 1) and RG-LRU cases of
     its own, bit for bit (S 1, 45, 300 and 513, not multiples of its
     32-step tiles; W 300 and 33; B 1; decays of exactly 1.0 and near 0);
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
     rows, seq 128, width 2560, f32), the quantizer bit for bit at the
     path's rows (2560 f32, recurrentgemma's RG-LRU input; 64 bf16,
     rwkv6-7b's r/k/v; 256 bf16, recurrentgemma's K/V), flash attention
     with float and int8 K/V at D = 256 (10 query heads over one kv head,
     window 2048) and at D = 32, each also at a ragged smoke-size shape, and
     the WKV-6 and RG-LRU cases of phase 13 for both entries;
     then the gradients of ``ops.rwkv6_scan``,
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

The serve engine (``repro_torch.serve.ServeEngine``: continuous batching,
chunked prefill stepped through ``decode_step``, a prefix cache over a page
pool; after recurrent training):
 20. the paged decode kernels, native and int8, against their plain versions
     and, bit for bit, against the contiguous decode kernel on the gathered
     rows: at deepseek-7b's shape (B 8, 32 heads of 128, pages of 8, 577-row
     tables over a scattered pool, ragged valid lengths incl. 0 and 1; f32
     and bf16), qwen3's GQA-8 (32 heads over 4), a window of 256, ragged
     smoke-size cases with pages of 16 (D 32, 16, 256), three rows
     sharing their first pages, and lengths around the decode split's chunk
     (0, 1, chunk - 1, chunk, chunk + 1; windows starting inside a chunk;
     pages of 8 and 16); times and bounds as in phase 3, the contiguous
     kernel's time on the same rows beside them;
 21. ServeEngine on the smoke configs (dense, both MoE, rwkv6, recurrentgemma;
     f32; tests/test_serve_engine.py's engine config): greedy tokens from the
     plain path on the CPU and the kernels on the card identical, native and
     int8 cache, and equal to ``ServeSession.generate``'s on the card where
     both routes agree by construction (native cache, or recurrentgemma
     whose generate also steps its prompt: with an int8 cache the two
     prefill routes may round K/V to different int8 rows, and the
     reference's own engine and generate part at qwen3-moe);
     ``benchmarks/serve_smoke.py``'s three checks (admit mid-decode, prefix
     cache hit, streaming order) on the card; a masked decode step keeps an
     inactive slot's cache bit for bit;
 22. deepseek-7b at its published size (30 layers, bf16, seed-0 weights)
     through ``run_load``: 12 requests submitted at once, prompt 64 of which
     32 are a shared prefix, 32 greedy tokens, 8 slots of 128 rows, a pool of
     128 blocks of 8, chunks of 16 under a budget of 64, native and int8 KV:
     the load report (wall, req/s, tok/s, latency and TTFT p50/p99, steps,
     prefix hit rate; a smoke reading, not a cell: the lengths are set, not
     drawn from a trace, and a p99 of 12 requests is their maximum), peak
     memory, launches, the share of tokens equal to
     ``generate``'s (a reading); then the paged kernels over the engine's own
     pool and block tables for every layer, against the contiguous kernel on
     the same rows gathered and the plain version.  The engine's own decode
     runs the contiguous kernel over its slots, as the reference's does, so
     the paged launches of this path are those of the pool check.

Checkpoint / restart and elastic replanning (``Session.run`` with a
``checkpoint_dir``, ``Session.apply``; after the engine, before the profiles):
 23. deepseek-7b at full width cut to 2 layers (1.244 B params: bf16 params
     and f32 AdamW state are a 12.4 GB checkpoint), seq 256, f32, the demo
     fleet, in a temporary directory removed at the end (short disk fails):
     S0 trains 6 steps and saves once, synchronously; S1 (checkpoint every
     3, async) trains 3; its checkpoint, restored with every CRC checked,
     equals S1's state bit for bit; S2 (S1's config and directory) resumes at
     step 3: its first batch is S0's fourth and its losses and grad norms at
     steps 4-6 equal S0's to rtol 1e-6 (and whether bit-equal); checkpoint
     bytes, free disk, sync save s, the async save's snapshot ms against the
     step's ms, the background write s and restore s;
 24. 2 steps, ``WorkerLost(["csd/1"])``, 2 steps, ``WorkerJoined("csd", 1)``,
     2 steps, params and optimizer state carried across: the smoke config on
     the CPU and on the card from the same weights in f32 and int8-fused
     (losses within phase 7's tolerances, the step rebuilt exactly when the
     rows change, as the reference rebuilds it, no private shard re-homed,
     launches of 6 steps), then phase 23's model in int8-fused on the card,
     step ms before and after each event.

Each record of the kernels line carries the main path (``serving``,
``training``, ``moe_serving``, ``recurrent_serving``, ``recurrent_training``
or ``engine_serving``) whose shapes it was
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
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12                      # H100 SXM device memory rate
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16; f32 FMA
N_TIMED = 25
MOE_KERNELS = ("moe_gate_up_kernel", "moe_down_kernel", "moe_gate_up_tc_kernel",
               "moe_down_tc_kernel", "moe_gate_up_skinny_kernel", "moe_down_skinny_kernel",
               "moe_invert_kernel", "moe_combine_kernel", "moe_combine_scan_kernel")
# the kernels that must run on the tensor cores (phase 2)
TENSOR_CORE_KERNELS = (("flash_fwd_tc_kernel", "flash_fwd_int8_tc_kernel") + MOE_KERNELS[2:6]
                       + ("wkv6_chunk_kernel",))
WKV6_CHUNK = 16                            # csrc/rwkv6_scan.cu's chunk of steps
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


def kernel_ms(torch, fn, flush, groups):
    """Device ms per call of ``fn()`` spent in each group of kernels (``{label:
    name substrings}``), from ``torch.profiler`` over N_TIMED calls, L2 flushed
    before each: the mean; None where the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(N_TIMED):
            flush()
            fn()
        torch.cuda.synchronize()
    sums = {label: None for label in groups}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, names in groups.items():
            if any(n in e.name for n in names):
                sums[label] = (sums[label] or 0.0) + (e.time_range.end - e.time_range.start)
    return {k: (None if v is None else v / N_TIMED / 1e3) for k, v in sums.items()}


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


def sass_report(lib_dir: Path, nvcc: str):
    """Tensor-core instructions in each compiled kernel's SASS
    (``cuobjdump --dump-sass`` on the built libraries): ``{kernel: (HMMA,
    HGMMA)}`` with demangled, shortened names."""
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    counts = {}
    for lib in sorted(lib_dir.glob("lib*.so")):
        sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                counts[name] = [0, 0]
            elif name is not None:
                counts[name][0] += len(re.findall(r"\bHMMA\.", line))
                counts[name][1] += len(re.findall(r"\bHGMMA\.", line))
    mangled = sorted(counts)
    short = mangled
    if mangled and shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        short = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                 for n in plain]
    return {s: tuple(counts[m]) for s, m in zip(short, mangled)}


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def wkv6_ops(B, S, H, D):
    """The WKV-6 scan's least operations, the chunked form's (on the bf16
    tensor cores): per step of a (b, h), 2 D^2 for r (.) decay times the
    carried state, 2 D^2 for the state's update and 2 L D for the
    intra-chunk term and its product with v (its triangle, L = 16)."""
    return (4.0 * D * D + 2.0 * WKV6_CHUNK * D) * B * H * S


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


def tile_edge_checks(torch, R, dev):
    """Phase 3, the tiles' edges: the bf16 flash kernel, over bf16 and over
    int8 K/V, at lengths that are not a multiple of its tiles, windows that
    end inside a tile, GQA-8, 10-over-1 and every head dim; the decode
    kernels at lengths around the
    split's chunk, 0 and 1, and a window that starts inside a chunk; each
    against its plain version, bf16 outputs to 2 bf16 ulps of each row."""
    from repro_torch.kernels.decode_attention import (
        chunk_rows, decode_attention, decode_attention_int8,
    )
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    # B, S, H, Hkv, D, causal, window
    flash_cases = [(2, S, 4, 4, 128, True, None) for S in (1, 63, 65, 129)]
    flash_cases += [(2, 200, 4, 4, 128, True, 8), (2, 200, 4, 4, 128, True, 100),
                    (2, 129, 32, 4, 128, True, None), (2, 129, 10, 1, 256, True, 100),
                    (3, 65, 4, 2, 16, True, None), (3, 65, 4, 2, 32, True, 8),
                    (2, 100, 8, 8, 128, False, None), (2, 77, 10, 1, 256, False, 8)]
    for B, S, H, Hkv, D, causal, window in flash_cases:
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        tag = f"S={S} H={H}/{Hkv} D={D} causal={causal} window={window} bf16"
        row_ulp_check(torch, f"flash_attention edge {tag}",
                      flash_attention_fwd(q, k, v, causal=causal, window=window),
                      R.flash_attention_ref(q, k, v, causal=causal, window=window))
        # the same cases over int8 K/V (the bf16-query tensor-core route)
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        row_ulp_check(torch, f"flash_attention_q8 edge {tag}",
                      flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=causal, window=window),
                      R.flash_attention_ref(q, R.dequantize_int8_ref(kq, ks),
                                            R.dequantize_int8_ref(vq, vs), causal=causal,
                                            window=window))
    for H, Hkv, D in ((32, 4, 128), (10, 1, 256), (32, 32, 128), (4, 2, 16), (4, 1, 32)):
        ch = chunk_rows(D, bf16)
        rows = 2 * ch + 8
        valid = torch.tensor([ch - 1, ch, ch + 1, 0, 1, ch + ch // 2, rows, 2 * ch + 1],
                             dtype=torch.int32, device=dev)
        q = randn(8, 1, H, D)
        k, v = randn(8, rows, Hkv, D), randn(8, rows, Hkv, D)
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        for window in (None, 100, 20):
            tag = f"H={H}/{Hkv} D={D} valid {valid.tolist()} window={window} bf16"
            row_ulp_check(torch, f"decode_attention edge {tag}",
                          decode_attention(q, k, v, valid, window=window),
                          R.decode_attention_ref(q, k, v, valid, window=window))
            row_ulp_check(torch, f"decode_attention_int8 edge {tag}",
                          decode_attention_int8(q, kq, ks, vq, vs, valid, window=window),
                          R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid, window=window))
    torch.cuda.empty_cache()


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
    """Phase 12, serving: the decode step of phase 5 and the engine decode
    step of phase 22."""
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
    profile_engine_step(torch, get_model, get_config, params, dev)


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
                "decode_attention" if "decode_kernel" in name or "decode_tc_kernel" in name else
                "quantize" if "quantize_rows_" in name else
                "wkv6_scan" if "wkv6_kernel" in name or "wkv6_chunk_kernel" in name else
                "rglru_scan" if "rglru_" in name else
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
    records.append(quant_record(torch, R, "training", rows, flush))     # noise 0.5
    cases = [("random noise", rows, torch.rand(rows.shape, generator=gen, device=dev)),
             ("ragged R=1001", rows[:1001], 0.5)]
    for label, x, noise in cases:
        quant_check(torch, R, f"{label}, {tuple(x.shape)} bf16", x, noise)
    del cases
    quantize_edge_checks(torch, R, dev)

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


def quant_check(torch, R, label, x, noise):
    """The quantizer on the card against its plain version, bit for bit."""
    from repro_torch.kernels.quantize import quantize_plan, quantize_rows

    aligned = x.data_ptr() % 16 == 0 and (not isinstance(noise, torch.Tensor)
                                          or noise.data_ptr() % 16 == 0)
    route = quantize_plan(*x.shape, x.dtype, aligned)
    got, want = quantize_rows(x, noise), R.quantize_int8_ref(x, noise)
    torch.cuda.synchronize()
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"[check] quantize_int8 {label} (route {route}): "
          f"{'bit-equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError(f"quantize_int8 ({label}) differs from its plain version")
    return route


def quant_record(torch, R, path, rows, flush):
    """The kernels-line record of the quantizer at noise 0.5 over ``rows``
    (R, N), checked bit for bit first; its route goes into ``shape``."""
    from repro_torch.kernels.quantize import quantize_rows

    dt = str(rows.dtype).split(".")[-1]
    route = quant_check(torch, R, f"{tuple(rows.shape)} {dt} at noise 0.5", rows, 0.5)
    R_, N = rows.shape
    nbytes = R_ * N * rows.element_size() + R_ * N + R_ * 4     # x in, q and scales out
    b_ms, b_by = bound(nbytes, 0.0, "float32")
    return dict(
        name="quantize_int8", path=path, shape=f"rows {tuple(rows.shape)} {dt}, route {route}",
        route="cuda", source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:38", launches=0, max_abs_err=0.0,
        ms=timed_ms(lambda: quantize_rows(rows, 0.5), flush),
        plain_ms=timed_ms(lambda: R.quantize_int8_ref(rows, 0.5), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def quantize_edge_checks(torch, R, dev):
    """Phase 6: the quantizer's routes at their edges, bit for bit against
    the plain version at noise 0.5 and at random noise: groups of 2 and 4
    lanes (rows of 16) and of 3 pieces in a group of 4 (24 bf16), widths
    that are no multiple of 16 bytes (45 and 300 bf16), the wide route at
    300 f32, views whose base is not 16-byte aligned, R of 1 and ragged R;
    every case holds a zero row (the scale floor), a row of one huge value
    among denormals and a row whose x / scale lands on .5 ties."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32

    def rows_of(R_, N, dtype):
        x = torch.randn(R_, N, generator=gen, device=dev) * 3.0
        specials = [torch.zeros(N, device=dev),
                    torch.rand(N, generator=gen, device=dev) * 1e-39,   # denormals
                    torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] * N,
                                 device=dev)[:N]]                      # scale 1: ties
        specials[1][N // 2] = 3.0e38
        for i, row in enumerate(specials if R_ >= len(specials) else []):
            x[(i * 7) % R_] = row
        return x.to(dtype)

    flat = torch.randn(1001 * 64 + 1, generator=gen, device=dev).to(bf16)
    odd = rows_of(1002, 45, bf16)
    cases = [(rows_of(1001, 16, f32), "rows of 16 f32"),
             (rows_of(1001, 16, bf16), "rows of 16 bf16"),
             (rows_of(333, 24, bf16), "rows of 24 bf16"),
             (rows_of(777, 45, bf16), "rows of 45 bf16"),
             (rows_of(513, 300, bf16), "rows of 300 bf16"),
             (rows_of(129, 300, f32), "rows of 300 f32"),
             (rows_of(1, 64, bf16), "R=1 rows of 64 bf16"),
             (rows_of(1, 2560, f32), "R=1 rows of 2560 f32"),
             (rows_of(4099, 64, bf16), "ragged rows of 64 bf16"),
             (rows_of(37, 2560, f32), "ragged rows of 2560 f32"),
             (odd[1:], "a view one row into rows of 45 bf16"),
             (flat[1:].view(1001, 64), "a view one element in, rows of 64 bf16")]
    for x, label in cases:
        for noise in (0.5, torch.rand(x.shape, generator=gen, device=dev)):
            kind = "random noise" if isinstance(noise, torch.Tensor) else "noise 0.5"
            quant_check(torch, R, f"edge {label} {tuple(x.shape)}, {kind}", x, noise)
    # a noise tensor whose base is not 16-byte aligned takes the scalar route too
    x = rows_of(257, 64, bf16)
    noise = torch.rand(257 * 64 + 1, generator=gen, device=dev)[1:].view(257, 64)
    quant_check(torch, R, "edge rows of 64 bf16, a noise view one element in", x, noise)


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
        route, croute = FM.gemm_route(T, d, f, E, C, x.dtype), FM.combine_route(E * C, T, d)
        y = FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)
        want = R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate)
        torch.cuda.synchronize()
        err = (y.float() - want.float()).abs().max().item()
        # one bf16 ulp of the largest output: both compute the same f32 value
        # up to summation order, then round once to bf16
        tol = want.float().abs().max().item() * 2.0 ** -7
        ok = math.isfinite(err) and err <= tol
        print(f"[check] fused_moe_gemm {label} T={T} C={C} (route {route}): {n_live} of "
              f"{E * C} slots live ({n_exp} experts), {int((~keep).sum())} copies dropped; "
              f"max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_moe_gemm ({label}) disagrees with its plain version")
        out = FM.fused_moe_combine(y, slot_tok, T)
        same = torch.equal(out, R.fused_moe_combine_ref(y, slot_tok, T))
        print(f"[check] fused_moe_combine {label} (route {croute}): "
              f"{'bit-equal' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"fused_moe_combine ({label}) differs from its plain version")
        if label == "overflow":
            continue
        gemm = lambda: FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)  # noqa: E731
        split = kernel_ms(torch, gemm, flush, {"gate/up": ("moe_gate_up",),
                                               "down": ("moe_down",)})
        gu, dn = ("not measured" if v is None else f"{v:.4f} ms" for v in split.values())
        print(f"[time] fused_moe_gemm {label} (route {route}): gate/up {gu}, down {dn} "
              f"(profiler, mean of 25)")
        esz = x.element_size()
        nbytes = n_exp * w_bytes + x.numel() * esz + y.numel() * esz + slot_tok.numel() * 8
        b_ms, b_by = bound(nbytes, 6.0 * n_live * d * f, "bfloat16")
        records.append(dict(
            name="fused_moe_gemm", path="moe_serving", shape=label, route="cuda",
            source="src/repro_torch/kernels/csrc/fused_moe.cu",
            replaces="src/repro/kernels/fused_moe.py:140",
            launches=0, max_abs_err=err,
            ms=timed_ms(gemm, flush),
            plain_ms=timed_ms(lambda: R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate),
                              flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        kept = live.nonzero()[:, 0]
        tok_kept, y_kept = slot_tok[kept, 0].long(), y[kept]
        # a note, not a library time (no one call computes the whole
        # function): the three products as torch.bmm on rows gathered beforehand
        xs = torch.where(live[:, None], x[slot_tok[:, 0].long().clamp(max=T - 1)], 0)
        xs = xs.view(E, C, d)
        bmm_ms = timed_ms(
            lambda: torch.bmm(F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu), wo), flush)
        print(f"[time] fused_moe_gemm {label}: the three products as torch.bmm on gathered "
              f"rows {bmm_ms:.4f} ms (h in bf16: a yardstick, not the same function)")
        del xs
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
    moe_edge_checks(torch, R, dev)

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


def moe_edge_checks(torch, R, dev):
    """Phase 9, the routes' edges: the expert GEMM against its plain version
    (bf16 to one bf16 ulp of the largest output, float32 to 1e-5 of it) at a
    ragged f (96 over 64-column tiles) and d (48 over 32-deep stages), one
    token, dbrx's d 6144 x f 10,752 at C 4 (tc_decode) and C 160
    (tc_prefill), and 300 experts at C 8 (more than tc_decode lists:
    tc_prefill); the combine on both routes bit for bit against its plain
    version, and a token with more than MAX_K slots (a NaN row on both)."""
    from repro_torch.kernels import fused_moe as FM

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def combine_both(label, y, slot_tok, T, nan_rows=()):
        want = R.fused_moe_combine_ref(y, slot_tok, T)
        keep = [t for t in range(T) if t not in nan_rows]
        for route in FM.COMBINE_ROUTES:
            out = FM.fused_moe_combine(y, slot_tok, T, route=route)
            same = torch.equal(out[keep], want[keep]) and all(
                bool(out[t].isnan().all()) for t in nan_rows)
            print(f"[check] fused_moe_combine edge {label} (route {route}): "
                  f"{'bit-equal' if same else 'DIFFERS'}"
                  + (f", NaN rows {list(nan_rows)}" if nan_rows else ""))
            if not same:
                raise AssertionError(f"fused_moe_combine edge {label} ({route}) differs")

    # T, d, f, E, k, C, dtype
    cases = [(8, 64, 96, 8, 2, 8, bf16), (100, 48, 96, 4, 2, 64, bf16),
             (1, 2048, 768, 128, 8, 8, bf16), (8, 6144, 10752, 16, 4, 4, bf16),
             (512, 6144, 10752, 16, 4, 160, bf16), (8, 256, 128, 300, 2, 8, bf16),
             (8, 64, 96, 8, 2, 8, f32), (100, 48, 96, 4, 2, 64, f32)]
    for T, d, f, E, k, C, dt in cases:
        x = randn(T, d, dtype=dt)
        router = randn(d, E, std=d ** -0.5, dtype=f32)
        wg, wu = randn(E, d, f, std=d ** -0.5, dtype=dt), randn(E, d, f, std=d ** -0.5, dtype=dt)
        wo = randn(E, f, d, std=f ** -0.5, dtype=dt)
        slot_tok, slot_gate = FM.moe_routing(x, router, k, C)[:2]
        route = FM.gemm_route(T, d, f, E, C, dt)
        y = FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)
        want = R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate).float()
        err = (y.float() - want).abs().max().item()
        tol = want.abs().max().item() * (2.0 ** -7 if dt == bf16 else 1e-5)
        ok = math.isfinite(err) and err <= tol
        label = f"T={T} d={d} f={f} E={E} C={C} {str(dt).split('.')[-1]}"
        print(f"[check] fused_moe_gemm edge {label} (route {route}): max_abs_err={err:.3e} "
              f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_moe_gemm edge {label} disagrees with its plain version")
        combine_both(label, y, slot_tok, T)
        del x, wg, wu, wo, y, want
    # token 0 keeps 40 slots (> MAX_K), token 1 ten, the rest are empty
    slot_tok = torch.full((64, 1), 2, dtype=torch.int32, device=dev)
    slot_tok[:40], slot_tok[40:50] = 0, 1
    combine_both("T=2 S=64, 40 slots of token 0", randn(64, 32), slot_tok, 2, nan_rows=(0,))
    torch.cuda.empty_cache()


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


def wkv6_edge_checks(torch, R, dev, int8):
    """Phases 13 and 17: WKV-6 cases of their own generator (the phases'
    other cases draw what they drew before) against the plain version, for
    the float entry or (``int8``) the int8 entry at the training quantizer's
    rows: bf16 at S 45 and 300 (not multiples of the chunked kernel's 16
    steps), at head dim 16, and with decays near 1e-30 (the floor) and near 1
    (a long memory)."""
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_int8

    gen = torch.Generator(device=dev)
    gen.manual_seed(9191)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def q8(x):
        q, s = quantize_rows(x.reshape(-1, x.shape[-1]), 0.5)
        return q.view(x.shape), s.view(x.shape[:-1] + (1,))

    for label, (B, S, H, D), decay in (("S=45", (2, 45, 4, 64), "model"),
                                       ("S=300", (2, 300, 4, 64), "model"),
                                       ("D=16", (2, 45, 4, 16), "model"),
                                       ("decay ~1e-30", (2, 300, 4, 64), "floor"),
                                       ("decay ~1", (2, 300, 4, 64), "one")):
        r, k, v = (randn(B, S, H, D).to(bf16) for _ in range(3))
        if decay == "model":
            w = torch.exp(-torch.exp(randn(B, S, H, D) * 0.5))
        elif decay == "floor":
            w = 1e-30 * (1 + torch.rand(B, S, H, D, generator=gen, device=dev))
        else:
            w = 1 - 0.01 * torch.rand(B, S, H, D, generator=gen, device=dev)
        w, u = w.to(bf16), randn(H, D)
        if int8:
            (rq, rs), (kq, ks), (vq, vs) = q8(r), q8(k), q8(v)
            out, state = rwkv6_scan_int8(rq, rs, kq, ks, vq, vs, w, u, bf16)
            want_out, want_state = R.rwkv6_scan_ref(
                R.dequantize_int8_ref(rq, rs), R.dequantize_int8_ref(kq, ks),
                R.dequantize_int8_ref(vq, vs), w, u)
            name = "rwkv6_scan_q8"
        else:
            out, state = rwkv6_scan(r, k, v, w, u)
            want_out, want_state = R.rwkv6_scan_ref(r, k, v, w, u)
            name = "rwkv6_scan"
        torch.cuda.synchronize()
        # as the phases hold the bf16 kernels: one bf16 ulp of the largest
        # |out|; the state to rtol 1e-4 plus 1e-4 of its largest |value|
        tag = f"{name} edge {label} {(B, S, H, D)}"
        want_out = want_out.to(bf16)
        atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
        close_check(torch, f"{tag} bf16 out", out, want_out, 0.0, atol)
        close_check(torch, f"{tag} state", state, want_state, 1e-4,
                    1e-4 * want_state.abs().max().item())


def bit_check(torch, label, got, want):
    """``got`` equals ``want`` bit for bit; -> 0.0, the error."""
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"[check] {label}: {'bit-equal' if same else 'DIFFERS'}")
    if not same:
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{label} differs from its plain version (max_abs_err={err:.3e})")
    return 0.0


def rglru_edge_checks(torch, R, dev, int8):
    """The RG-LRU scan's cases of its own, bit for bit against the plain
    version: the float entry or (``int8``) the int8 entry over the training
    quantizer's x.  S of 1, 45, 300 and 513 (no multiples of the kernel's
    32-step tiles), W of 300 (a partial block; for int8 x, rows that are no
    multiple of 16 bytes) and 33 (no multiple of 4: 4-byte pieces), B of 1,
    and decays of exactly 1.0 (every third channel) and near 0 (every third
    from the second, 1e-30 to 1e-6) among decays in (0.5, 1)."""
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_int8

    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    name = "rglru_scan_q8" if int8 else "rglru_scan"
    for B, S, W in ((2, 1, 2560), (2, 45, 2560), (2, 300, 2560), (2, 513, 2560),
                    (2, 45, 300), (1, 513, 300), (3, 70, 33)):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.5 + 0.5
        a[..., 0::3] = 1.0
        a[..., 1::3] = 10.0 ** (-6.0 - 24.0 * torch.rand(B, S, len(range(1, W, 3)),
                                                         generator=gen, device=dev))
        x = torch.randn(B, S, W, generator=gen, device=dev)
        if int8:
            q, s = quantize_rows(x.view(-1, W), 0.5)
            xq, xs = q.view(B, S, W), s.view(B, S, 1)
            got, want = rglru_scan_int8(a, xq, xs), R.rglru_scan_ref(
                a, R.dequantize_int8_ref(xq, xs))
        else:
            got, want = rglru_scan(a, x), R.rglru_scan_ref(a, x)
        bit_check(torch, f"{name} edge {(B, S, W)}, decays of 1.0 and near 0", got, want)


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
            b_ms, b_by = bound(nbytes, wkv6_ops(B, S, H, D), "bfloat16")
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
    wkv6_edge_checks(torch, R, dev, int8=False)

    # -- RG-LRU scan: recurrentgemma-2b's prefill (B 8, S 512, lru_width 2560)
    #    and a case ragged in S and W; decays in (0.5, 0.999) so the carry
    #    lives; bit for bit (both round a multiply, then an add, in step order)
    for label, (B, S, W) in (("prefill", (8, 512, 2560)), ("ragged", (2, 45, 300))):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
        x = randn(B, S, W)
        err = bit_check(torch, f"rglru_scan {label} {(B, S, W)} f32", rglru_scan(a, x),
                        R.rglru_scan_ref(a, x))
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
    rglru_edge_checks(torch, R, dev, int8=False)

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
        ops_ = wkv6_ops(B, S, H, D)
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
                       err, kernel, plain, nbytes, ops_, "bfloat16")
            del out, state, want_out, want_state
        del r, k, v, w, u, rq, rs, kq, ks, vq, vs, rd, kd, vd
    for int8 in (False, True):
        wkv6_edge_checks(torch, R, dev, int8)

    # -- RG-LRU, float and int8: recurrentgemma-2b's training shape (60 rows,
    #    seq 128, lru width 2560, f32 gates) and a ragged one; bit for bit,
    #    and the quantizer at rows of W bit for bit too
    for label, (B, S, W) in (("train", (60, 128, 2560)), ("ragged", (2, 45, 300))):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
        x = randn(B, S, W)
        if label == "train":
            records.append(quant_record(torch, R, "recurrent_training", x.view(-1, W), flush))
        else:
            quant_check(torch, R, f"rows of {W} f32 {tuple(x.shape)}", x.view(-1, W), 0.5)
        xq, xs = q8(x)
        xd = deq(xq, xs)
        for name, kernel, plain in (("rglru_scan", lambda: rglru_scan(a, x),
                                     lambda: R.rglru_scan_ref(a, x)),
                                    ("rglru_scan_q8", lambda: rglru_scan_int8(a, xq, xs),
                                     lambda: R.rglru_scan_ref(a, xd))):
            bit_check(torch, f"{name} {label} {(B, S, W)} f32", kernel(), plain())
            if label == "train":
                x_bytes = xq.numel() + xs.numel() * 4 if name.endswith("q8") else x.numel() * 4
                record(name, f"train {(B, S, W)}", "rglru_scan.cu",
                       "rglru_scan.py:103" if name.endswith("q8") else "rglru_scan.py:65",
                       0.0, kernel, plain, 2 * a.numel() * 4 + x_bytes, 2.0 * x.numel(),
                       "float32")
        del a, x, xq, xs, xd
    rglru_edge_checks(torch, R, dev, int8=True)

    # -- the quantizer at the path's other rows, bit for bit: rwkv6-7b's r, k
    #    and v (60 x 256 x 64 heads, rows of 64 bf16) and recurrentgemma-2b's
    #    K and V (60 x 128 x one kv head, rows of 256 bf16)
    for R_, N in ((60 * 256 * 64, 64), (60 * 128, 256)):
        rows = randn(R_, N).to(bf16)
        records.append(quant_record(torch, R, "recurrent_training", rows, flush))
        del rows

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


# ---------------------------------------------------------------------------
# The serve engine (continuous batching) and the paged decode kernels
# ---------------------------------------------------------------------------

# tests/test_serve_engine.py's SMOKE_CONFIG
ENGINE_SMOKE = dict(max_slots=2, max_len=48, block_size=4, num_blocks=32, prefill_chunk=8,
                    token_budget=16)
# phase 22's load, engine_deepseek7b_shared_prefix: a smoke reading of the
# engine path, not yet a cell (its lengths are set here, not drawn from a
# public trace; prompts are short because the stepped prefill takes a
# batch-1 decode step a token; a p99 over 12 requests is their maximum)
ENGINE_FULL = dict(max_slots=8, max_len=128, block_size=8, num_blocks=128, prefill_chunk=16,
                   token_budget=64)
ENGINE_LOAD = dict(n_requests=12, prompt_len=64, max_new_tokens=32, shared_prefix_len=32, seed=0)
ENGINE_CASES = (("deepseek-7b", "native"), ("deepseek-7b", "int8"),
                ("qwen3-moe-30b-a3b", "native"), ("qwen3-moe-30b-a3b", "int8"),
                ("dbrx-132b", "native"), ("dbrx-132b", "int8"), ("rwkv6-7b", "native"),
                ("recurrentgemma-2b", "native"), ("recurrentgemma-2b", "int8"))


def paged_kernel_checks(torch, R, dev):
    """Phase 20: the paged decode kernels against their plain versions, and
    against the contiguous kernel on the gathered rows."""
    from repro_torch.kernels.decode_attention import (
        chunk_rows, decode_attention, decode_attention_int8, paged_decode_attention,
        paged_decode_attention_int8,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(2020)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # as phase 3
    records = []

    def rand(*shape, dtype, gen=gen):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def check(label, got, want, t):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= t
        print(f"[check] {label}: max_abs_err={err:.3e} tol={t:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version: {err} > {t}")
        return err

    def same(label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"{label}: paged and contiguous kernels differ by {err}")
        print(f"[check] {label}: paged == contiguous on the gathered rows, bit for bit")

    valid577 = [576, 1, 300, 513, 576, 0, 450, 520]
    cases = [
        # label, B, H, Hkv, D, page, rows, valid, window, dtypes, record
        ("deepseek-7b MHA", 8, 32, 32, 128, 8, 577, valid577, None,
         (torch.float32, torch.bfloat16), True),
        ("qwen3 GQA-8", 8, 32, 4, 128, 8, 577, valid577, None, (torch.bfloat16,), True),
        ("MHA window 256", 8, 32, 32, 128, 8, 577, valid577, 256, (torch.bfloat16,), False),
        ("smoke D=32 GQA-2", 3, 4, 2, 32, 16, 45, [45, 0, 17], None,
         (torch.float32, torch.bfloat16), False),
        ("smoke D=16 MQA window 12", 3, 2, 1, 16, 16, 40, [40, 1, 23], 12,
         (torch.float32,), False),
        ("smoke D=256 MQA-10", 2, 10, 1, 256, 16, 70, [70, 33], None, (torch.bfloat16,), False),
    ]
    # lengths around the decode split's chunk, 0 and 1; windows starting
    # inside a chunk; pages of 8 and 16
    def edge(ch):
        return [ch - 1, ch, ch + 1, 0, 1, ch + ch // 2, 2 * ch + 8, 2 * ch + 1]

    c64, c256 = chunk_rows(128, torch.bfloat16), chunk_rows(256, torch.bfloat16)
    edge_cases = [
        ("edge lengths GQA-4", 8, 8, 2, 128, 8, 2 * c64 + 8, edge(c64), None,
         (torch.float32, torch.bfloat16), False),
        ("edge lengths MHA window 100", 8, 4, 4, 128, 16, 2 * c64 + 8, edge(c64), 100,
         (torch.bfloat16,), False),
        ("edge lengths MQA-10 D=256 window 20", 8, 10, 1, 256, 8, 2 * c256 + 8, edge(c256), 20,
         (torch.bfloat16,), False),
        ("edge lengths D=16 window 70", 8, 2, 1, 16, 16, 2 * c64 + 16, edge(c64), 70,
         (torch.float32,), False),
    ]
    def run_cases(cases, gen):
        for label, B, H, Hkv, D, page, rows, valid_l, window, dtypes, record in cases:
            NP = -(-rows // page)
            valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
            live = int(valid.sum())
            P = B * NP + 5                   # the rows' pages scattered over a pool
            table = torch.randperm(P, generator=gen, device=dev)[:B * NP].reshape(B, NP).to(
                torch.int32)
            for dtype in dtypes:
                name = f"{label} {str(dtype).split('.')[-1]}"
                q = rand(B, 1, H, D, dtype=dtype, gen=gen)
                kp, vp = (rand(P, page, Hkv, D, dtype=dtype, gen=gen) for _ in range(2))
                run = lambda: paged_decode_attention(q, kp, vp, table, valid, window=window)
                plain = lambda: R.paged_decode_attention_ref(q, kp, vp, table, valid, window=window)
                err = check(f"paged_decode_attention {name}", run(), plain(), tol[dtype])
                kc, vc = R.gather_pages(kp, table), R.gather_pages(vp, table)
                contiguous = lambda: decode_attention(q, kc, vc, valid, window=window)
                same(f"paged_decode_attention {name}", run(), contiguous())
                (kq, ks), (vq, vs) = R.quantize_int8_ref(kp), R.quantize_int8_ref(vp)
                run8 = lambda: paged_decode_attention_int8(q, kq, ks, vq, vs, table, valid,
                                                           window=window)
                plain8 = lambda: R.paged_decode_attention_int8_ref(q, kq, ks, vq, vs, table, valid,
                                                                   window=window)
                err8 = check(f"paged_decode_attention_int8 {name}", run8(), plain8(), tol[dtype])
                gq = [R.gather_pages(t, table) for t in (kq, ks, vq, vs)]
                contiguous8 = lambda: decode_attention_int8(q, *gq, valid, window=window)
                same(f"paged_decode_attention_int8 {name}", run8(), contiguous8())
                if record and dtype == torch.bfloat16:
                    # bytes: each live row's K and V once (per sequence, as the TPU
                    # kernel reads shared pages), q and out, the live pages' table
                    # entries and valid_len
                    pages_read = sum(-(-v // page) for v in valid_l)
                    small = 2 * q.numel() * 2 + 4 * pages_read + 4 * B
                    for nm, fn, pl, cf, nbytes, e in (
                            ("paged_decode_attention", run, plain, contiguous,
                             2 * live * Hkv * D * 2 + small, err),
                            ("paged_decode_attention_int8", run8, plain8, contiguous8,
                             2 * live * Hkv * (D + 4) + small, err8)):
                        b_ms, b_by = bound(nbytes, 4 * D * H * live, "bfloat16")
                        rec = dict(
                            name=nm, path="engine_serving", via="engine pool check",
                            route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
                            replaces=("src/repro/kernels/decode_attention.py:265"
                                      if nm.endswith("int8") else
                                      "src/repro/kernels/decode_attention.py:202"),
                            launches=0, max_abs_err=e, ms=timed_ms(fn, flush),
                            plain_ms=timed_ms(pl, flush), bound_ms=b_ms, bound_by=b_by,
                            # no one PyTorch call computes a paged decode: a gather
                            # and then SDPA is two
                            library_ms=None, contiguous_ms=timed_ms(cf, flush))
                        if label != "deepseek-7b MHA":
                            rec["shape"] = label
                        records.append(rec)
                del q, kp, vp, kc, vc, kq, ks, vq, vs, gq

    run_cases(cases, gen)

    # three rows sharing their first pages (a cached prefix)
    B, H, Hkv, D, page = 3, 32, 32, 128, 8
    P = 8
    table = torch.tensor([[0, 1, 2, 3], [0, 1, 4, 5], [0, 1, 6, 7]], dtype=torch.int32,
                         device=dev)
    valid = torch.tensor([32, 25, 17], dtype=torch.int32, device=dev)
    q = rand(B, 1, H, D, dtype=torch.bfloat16)
    kp, vp = (rand(P, page, Hkv, D, dtype=torch.bfloat16) for _ in range(2))
    got = paged_decode_attention(q, kp, vp, table, valid)
    same("paged_decode_attention shared prefix", got,
         decode_attention(q, R.gather_pages(kp, table), R.gather_pages(vp, table), valid))
    check("paged_decode_attention shared prefix", got,
          R.paged_decode_attention_ref(q, kp, vp, table, valid), tol[torch.bfloat16])
    (kq, ks), (vq, vs) = R.quantize_int8_ref(kp), R.quantize_int8_ref(vp)
    got8 = paged_decode_attention_int8(q, kq, ks, vq, vs, table, valid)
    same("paged_decode_attention_int8 shared prefix", got8,
         decode_attention_int8(q, *(R.gather_pages(t, table) for t in (kq, ks, vq, vs)), valid))
    check("paged_decode_attention_int8 shared prefix", got8,
          R.paged_decode_attention_int8_ref(q, kq, ks, vq, vs, table, valid),
          tol[torch.bfloat16])
    edge_gen = torch.Generator(device=dev)
    edge_gen.manual_seed(2121)
    run_cases(edge_cases, edge_gen)
    del scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def _engine_tokens(engine, prompts, n):
    return [o.tokens for o in engine.generate_batch(prompts, max_new_tokens=n)]


def serve_smoke_checks(make, vocab, what):
    """``benchmarks/serve_smoke.py``'s three checks, on engines from ``make()``."""
    rng = np.random.default_rng(0)
    p0, p1 = rng.integers(0, vocab, 6).tolist(), rng.integers(0, vocab, 6).tolist()
    solo = [_engine_tokens(make(), [p], 6)[0] for p in (p0, p1)]
    eng = make()
    r0 = eng.submit(p0, max_new_tokens=6)
    eng.step()                                   # r0 prefills and starts decoding
    r1 = eng.submit(p1, max_new_tokens=3)        # lands mid-decode
    first_r1 = r0_done = None
    step = 1
    while eng.has_work():
        for ev in eng.step():
            if ev.request_id == r1 and first_r1 is None:
                first_r1 = step
            if ev.request_id == r0 and ev.done:
                r0_done = step
        step += 1
    if first_r1 is None or r0_done is None or not first_r1 < r0_done:
        raise AssertionError(f"{what}: r1 first token at {first_r1}, r0 done at {r0_done}")
    if eng.output(r0).tokens != solo[0] or eng.output(r1).tokens != solo[1][:3]:
        raise AssertionError(f"{what}: interleaving changed the tokens")
    print(f"[serve-smoke] {what} admit-mid-decode: r1 first token at step {first_r1}, r0 "
          f"done at step {r0_done}, outputs equal the solo runs")

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, 12).tolist()
    prompts = [prefix + rng.integers(0, vocab, 4).tolist() for _ in range(3)]
    cold = [_engine_tokens(make(), [p], 4)[0] for p in prompts]
    eng = make()
    warm = _engine_tokens(eng, prompts, 4)
    stats = eng.prefix_cache_stats
    if stats.hit_blocks <= 0 or warm != cold:
        raise AssertionError(f"{what}: prefix cache hits {stats.hit_blocks}, warm == cold "
                             f"{warm == cold}")
    print(f"[serve-smoke] {what} prefix cache: hit rate {stats.hit_rate:.3f} "
          f"({stats.hit_blocks}/{stats.queries} block probes), hits equal the cold runs")

    eng = make()
    rng = np.random.default_rng(2)
    rids = [eng.submit(rng.integers(0, vocab, 5).tolist(), max_new_tokens=4) for _ in range(3)]
    events = {r: [] for r in rids}
    while eng.has_work():
        for ev in eng.step():
            events[ev.request_id].append(ev)
    for rid in rids:
        evs = events[rid]
        if ([e.index for e in evs] != list(range(len(evs))) or sum(e.done for e in evs) != 1
                or not evs[-1].done or [e.token for e in evs] != eng.output(rid).tokens):
            raise AssertionError(f"{what}: request {rid}'s stream is out of order: {evs}")
    print(f"[serve-smoke] {what} streaming: {len(rids)} requests, consecutive indices, "
          f"one terminal event each")


def _slot_copy(tree, slot):
    return {k: _slot_copy(v, slot) if isinstance(v, dict) else v[:, slot].clone()
            for k, v in tree.items()}


def masked_step_check(torch, model, params, dev, stale_pos, what):
    """One masked decode step on the card: the inactive slot (its stale
    position inside rows it holds) is kept bit for bit, the active one moves."""
    from repro_torch.serve.runner import StepRunner

    cache = model.init_cache(2, 24, device=dev)
    runner = StepRunner(model)
    prompt = torch.from_numpy(np.random.default_rng(9).integers(0, model.cfg.vocab, (2, 16)))
    runner.extend(params, prompt.to(dev), cache, 0)
    before = [_slot_copy(cache, s) for s in (0, 1)]
    tok, _ = runner.decode(params, torch.tensor([[3], [4]], dtype=torch.int32, device=dev),
                           cache, np.asarray([16, stale_pos], np.int32),
                           np.asarray([True, False]), [None, None], np.zeros(2, np.float32),
                           np.zeros(2, np.int32))
    idle_same = all(torch.equal(a, b) for a, b in zip(_leaves(_slot_copy(cache, 1)),
                                                        _leaves(before[1])))
    active_moved = any(not torch.equal(a, b) for a, b in zip(_leaves(_slot_copy(cache, 0)),
                                                               _leaves(before[0])))
    if not (idle_same and active_moved and int(tok[1]) == 0):
        raise AssertionError(f"{what}: masked step: idle slot kept {idle_same}, active "
                             f"slot moved {active_moved}")
    print(f"[masked-step] {what}: the inactive slot (stale pos {stale_pos}) is bit-identical "
          f"after the step, the active one moved")


def cross_device_engine(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 21: ServeEngine on the smoke configs in f32, plain path on the
    CPU vs kernels on the card, and the serve-smoke checks on the card."""
    from repro_torch.serve import EngineConfig, ServeEngine

    config = EngineConfig(**ENGINE_SMOKE)
    weights = {}
    for arch, kv in ENGINE_CASES:
        base = smoke_config(arch)
        model = get_model(base.with_(kv_cache_dtype=kv))
        if arch not in weights:
            cpu_params, _ = model.init_params(seed=0, device="cpu")
            weights[arch] = (cpu_params, _to(cpu_params, dev))
        cpu_params, gpu_params = weights[arch]
        prompts = np.random.default_rng(1).integers(0, base.vocab, (3, 11))
        plist = [p.tolist() for p in prompts]
        want = _engine_tokens(ServeEngine(model=model, params=cpu_params, config=config,
                                          device="cpu"), plist, 6)
        ops.reset_launches()
        got = _engine_tokens(ServeEngine(model=model, params=gpu_params, config=config,
                                         device=dev), plist, 6)
        counts = {k: c for k, c in ops.LAUNCHES.items() if c}
        print(f"[engine] {arch} {kv}: cpu={want} gpu={got} launches={counts}")
        if want != got:
            raise AssertionError(f"{arch} {kv}: engine greedy tokens differ between CPU and card")
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        needed = {"dense": (decode_op,), "moe": (decode_op, "fused_moe_gemm", "fused_moe_combine"),
                  "rglru": (decode_op,), "rwkv6": ()}[base.family]
        if any(counts.get(k, 0) == 0 for k in needed) or counts.get("flash_attention", 0):
            raise AssertionError(f"{arch} {kv}: the engine's steps missed a kernel: {counts}")
        # generate prefills attention families in one batch, the engine steps
        # the prompt: in float32 they agree on the smoke configs; with an int8
        # cache the two routes' K/V may round to different int8 rows and the
        # tokens part (the reference's own engine and generate do at qwen3-moe)
        if kv == "native" or base.family == "rglru":
            oracle = ServeSession(model=model, params=gpu_params, device=dev).generate(
                torch.from_numpy(prompts), max_new_tokens=5).tokens.cpu().tolist()
            if oracle != got:
                raise AssertionError(f"{arch} {kv}: engine {got} != generate {oracle} on the card")
            print(f"[engine] {arch} {kv}: engine tokens equal ServeSession.generate's on the card")
    for arch in ("deepseek-7b", "rwkv6-7b", "recurrentgemma-2b"):
        model, gpu_params = get_model(smoke_config(arch)), weights[arch][1]
        serve_smoke_checks(lambda: ServeEngine(model=model, params=gpu_params, config=config,
                                               device=dev), model.cfg.vocab, arch)
    for arch, kv, stale in (("deepseek-7b", "native", 5), ("deepseek-7b", "int8", 5),
                            ("qwen3-moe-30b-a3b", "native", 5), ("rwkv6-7b", "native", 5),
                            ("recurrentgemma-2b", "native", 3),
                            ("recurrentgemma-2b", "int8", 12)):
        model = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
        masked_step_check(torch, model, weights[arch][1], dev, stale, f"{arch} {kv}")


def _load_prompts(vocab):
    """The prompts ``run_load`` draws for ENGINE_LOAD (the same calls, in order)."""
    rng = np.random.default_rng(ENGINE_LOAD["seed"])
    P, S = ENGINE_LOAD["prompt_len"], ENGINE_LOAD["shared_prefix_len"]
    prefix = rng.integers(0, vocab, size=(S,)).tolist()
    return [prefix + rng.integers(0, vocab, size=(P - S,)).tolist()
            for _ in range(ENGINE_LOAD["n_requests"])]


def engine_pool_check(torch, ops, R, engine, prompts, dev, what):
    """The paged kernels over the engine's own page pool and block tables:
    for every request whose prompt blocks are still resident, each layer's
    paged decode against the contiguous kernel over the same rows gathered
    (bit for bit) and against the plain version."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.serve import hash_chain

    alloc, pool = engine.adapter.allocator, engine.adapter.pool
    bs = alloc.block_size
    rows = []
    for p in prompts:
        chain = hash_chain(p, bs)
        if all(alloc.contains(h) for h in chain):
            rows.append([alloc.lookup(h) for h in chain])
    if not rows:
        raise AssertionError(f"{what}: no request's blocks are resident in the pool")
    table = torch.tensor(rows, dtype=torch.int32, device=dev)
    n = table.shape[1] * bs
    cfg = engine.model.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    q = torch.randn(len(rows), 1, cfg.n_heads, cfg.resolved_head_dim(), generator=gen,
                    device=dev).to(cfg.dtype)
    valid = torch.full((len(rows),), n, dtype=torch.int32, device=dev)
    int8 = "k_scale" in pool
    got_all, plain_all = [], []
    for layer in range(cfg.n_layers):
        pages = [pool[k][layer] for k in (("k", "k_scale", "v", "v_scale") if int8 else ("k", "v"))]
        gathered = [R.gather_pages(t, table) for t in pages]
        if int8:
            got = ops.paged_decode_attention_int8(q, *pages, table, valid)
            contiguous = decode_attention_int8(q, *gathered, valid)
            plain = R.paged_decode_attention_int8_ref(q, *pages, table, valid)
        else:
            got = ops.paged_decode_attention(q, *pages, table, valid)
            contiguous = decode_attention(q, *gathered, valid)
            plain = R.paged_decode_attention_ref(q, *pages, table, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, contiguous):
            raise AssertionError(f"{what} layer {layer}: paged != contiguous on the pool's rows")
        got_all.append(got)
        plain_all.append(plain)
    # bf16 outputs of |O(10)|: hold each row to 2 bf16 ulps of its largest
    # value, as phase 13 does (both sides compute in f32 and round once)
    worst = row_ulp_check(torch, f"paged decode over the engine pool {what}, all layers",
                          torch.stack(got_all), torch.stack(plain_all))
    print(f"[engine-pool] {what}: {len(rows)} requests' {table.shape[1]} resident pages each, "
          f"{cfg.n_layers} layers: paged == contiguous bit for bit, max_abs_err vs plain "
          f"{worst:.3e}")


def full_width_engine(torch, ops, R, get_model, get_config, ServeSession, dev):
    """Phase 22: deepseek-7b at its published size through ServeEngine +
    run_load (the engine_deepseek7b_shared_prefix smoke reading), native and
    int8."""
    from repro_torch.serve import EngineConfig, ServeEngine, run_load

    cfg = get_config("deepseek-7b")
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    torch.cuda.synchronize()
    prompts = _load_prompts(cfg.vocab)
    N = ENGINE_LOAD["max_new_tokens"]
    totals = {name: 0 for name in ops.LAUNCHES}
    for kv in ("native", "int8"):
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        engine = ServeEngine(model=model, params=params, config=EngineConfig(**ENGINE_FULL),
                             device=dev)
        held = sum(t.numel() * t.element_size()
                   for t in _leaves(engine.adapter.cache)) + sum(
                       t.numel() * t.element_size() for t in _leaves(engine.adapter.pool))
        print(f"[engine-full] {kv}: slots + pool {held / 2**30:.3f} GiB, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated before the run")
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        report = run_load(engine, **ENGINE_LOAD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[engine-full] {kv}: {json.dumps(report.to_json())}")
        print(f"[engine-full] {kv}: wall {wall:.3f} s (run_load's clock {report.wall_s} s), "
              f"peak memory {peak / 2**30:.3f} GiB, decoded {engine.tokens_decoded}")
        engine_pool_check(torch, ops, R, engine, prompts, dev, f"deepseek-7b {kv}")
        counts = dict(ops.LAUNCHES)
        print(f"[engine-full] {kv}: launches {counts}")
        outs = [engine.output(r) for r in range(ENGINE_LOAD["n_requests"])]
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        paged_op = "paged_decode_attention_int8" if kv == "int8" else "paged_decode_attention"
        if any(len(o.tokens) != N or min(o.tokens) < 0 or max(o.tokens) >= cfg.vocab
               for o in outs):
            raise AssertionError(f"{kv}: engine outputs out of range")
        if report.prefix_hit_rate <= 0:
            raise AssertionError(f"{kv}: the shared prefix produced no cache hits")
        if (counts[decode_op] == 0 or counts[decode_op] % cfg.n_layers or counts["flash_attention"]
                or counts[paged_op] != cfg.n_layers):
            raise AssertionError(f"{kv}: launches {counts}")
        # the engine's greedy tokens beside generate's (batched prefill): a reading
        gen_out = ServeSession(model=model, params=params, device=dev).generate(
            torch.tensor(prompts, device=dev), max_new_tokens=N - 1).tokens.cpu()
        agree = (gen_out == torch.tensor([o.tokens for o in outs])).float().mean().item()
        print(f"[engine-full] {kv}: {agree:.3f} of the engine's tokens equal generate's")
        for name, c in counts.items():
            totals[name] += c
        del engine, gen_out
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return totals


def profile_engine_step(torch, get_model, get_config, params, dev, steps=4):
    """Phase 12, the engine: decode-only engine steps of phase 22's load
    (native KV; 8 requests in the 8 slots, every prompt prefilled), timed on
    the host clock and then profiled.  The first request prefills alone and
    publishes the shared prefix, so the other seven step only their own 32
    prompt tokens."""
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.scheduler import RequestStatus
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("deepseek-7b")
    engine = ServeEngine(model=get_model(cfg), params=params, config=EngineConfig(**ENGINE_FULL),
                         device=dev)
    prompts = _load_prompts(cfg.vocab)[:ENGINE_FULL["max_slots"]]

    def prefill(ps):
        for p in ps:
            engine.submit(p, max_new_tokens=ENGINE_LOAD["max_new_tokens"])
        while any(r.status is not RequestStatus.RUNNING
                  for r in engine.scheduler.requests.values()):
            engine.step()

    prefill(prompts[:1])
    prefill(prompts[1:])
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    busy = device_time_by_kind(torch, prof, steps, "engine decode step")
    if busy is not None:
        print(f"[profile] engine native: device busy {busy:.3f} ms of {step_ms:.3f} ms "
              f"per engine decode step (8 slots): idle share {1 - busy / step_ms:.3f}")
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Checkpoint / restart and elastic replanning (phases 23-24)
# ---------------------------------------------------------------------------

# the full-width cell of phases 23-24: deepseek-7b cut to 2 layers (1.244 B
# params; bf16 params + f32 AdamW state are 12.4 GB a checkpoint), seq 256
CKPT_LAYERS, CKPT_SEQ = 2, 256


def _recording(session):
    """Keep a host copy of the tokens of every batch the session's batcher
    hands out."""
    seen = []
    ds = session.dataset
    inner = ds.next_batch

    def next_batch():
        b = inner()
        seen.append(b["tokens"].copy())
        return b

    ds.next_batch = next_batch
    return seen


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def checkpoint_restart(torch, ops, train_session_factory, dev, root: Path):
    """Phase 23: deepseek-7b at full width (2 layers, seq 256, f32, the demo
    fleet): S0 runs 6 steps uninterrupted (one sync save at its end); S1
    (checkpoint every 3, async) runs 3 steps; its checkpoint is restored and
    held to S1's state bit for bit; S2 (same config and directory) resumes at
    step 3 and runs to 6, its batches and per-step losses and grad norms held
    to S0's."""
    from repro_torch.checkpoint import restore
    from repro_torch.checkpoint.manager import _flatten_with_paths

    kw = dict(arch="deepseek-7b", device=dev, full_config=True, n_layers=CKPT_LAYERS,
              seq=CKPT_SEQ, steps=6, precision="f32")
    s0 = train_session_factory(checkpoint_dir=str(root / "s0"), checkpoint_every=6, **kw)
    s0.config.async_checkpoint = False
    cfg = s0.model.cfg
    # params (bf16 at full width) + AdamW's f32 mu and nu + the 4-byte step
    like, _ = s0.model.init_params(abstract=True)
    expect_bytes = sum(t.numel() * (t.element_size() + 8) for t in _leaves(like)) + 4
    free = shutil.disk_usage(root).free
    need = 2 * expect_bytes                 # S2 writes step 6 beside S1's step 3
    print(f"[ckpt] {cfg.name}: {cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f} B params, "
          f"a checkpoint {expect_bytes / 1e9:.3f} GB; free disk {free / 1e9:.1f} GB under "
          f"{root} (needs {need / 1e9:.1f} GB)")
    if free < need:
        raise AssertionError(f"phase 23 needs {need / 1e9:.1f} GB of disk, {free / 1e9:.1f} GB "
                             f"are free")
    b0 = _recording(s0)
    r0 = s0.run()
    h0 = r0.history
    m0 = s0.checkpoints
    on_disk = _dir_bytes(root / "s0")
    print(f"[ckpt] S0: 6 steps, losses {[round(h['loss'], 6) for h in h0]}; sync save at step 6: "
          f"snapshot {m0.last_snapshot_s:.3f} s + write {m0.last_write_s:.3f} s = "
          f"{m0.last_snapshot_s + m0.last_write_s:.3f} s for {on_disk} bytes "
          f"({on_disk / (m0.last_snapshot_s + m0.last_write_s) / 1e9:.2f} GB/s)")
    if on_disk < expect_bytes:
        raise AssertionError(f"S0's checkpoint holds {on_disk} bytes, fewer than {expect_bytes}")
    shutil.rmtree(root / "s0")
    del s0, r0
    torch.cuda.empty_cache()

    run_dir = str(root / "run")
    s1 = train_session_factory(checkpoint_dir=run_dir, checkpoint_every=3, **kw)
    if not s1.config.async_checkpoint:
        raise AssertionError("S1 must save asynchronously")
    r1 = s1.run(steps=3)
    m1 = s1.checkpoints
    step_ms = statistics.median(h["step_time"] for h in r1.history[1:]) * 1e3
    print(f"[ckpt] S1: 3 steps ({step_ms:.3f} ms/step, median of steps 2-3), async save at "
          f"step 3: the caller blocked {m1.last_snapshot_s * 1e3:.1f} ms for the host snapshot "
          f"({m1.last_snapshot_s * 1e3 / step_ms:.2f} steps), the background write took "
          f"{m1.last_write_s:.3f} s")
    t = time.perf_counter()
    state, meta = restore(run_dir, {"params": r1.params, "opt": r1.opt_state}, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    saved = dict(_flatten_with_paths({"params": r1.params, "opt": r1.opt_state}))
    got = dict(_flatten_with_paths(state))
    differ = [k for k in saved if not (
        got[k] == saved[k] if isinstance(saved[k], int) else torch.equal(got[k], saved[k]))]
    print(f"[ckpt] restore of step {meta['step']} with CRC32 over every leaf: {restore_s:.3f} s; "
          f"{len(saved)} leaves, {len(differ)} differ from S1's state")
    if differ or meta["step"] != 3 or sorted(got) != sorted(saved):
        raise AssertionError(f"restored leaves differ from the saved ones: {differ[:5]}")
    del s1, r1, state, saved, got
    torch.cuda.empty_cache()

    s2 = train_session_factory(checkpoint_dir=run_dir, checkpoint_every=3, **kw)
    b2 = _recording(s2)
    ops.reset_launches()
    r2 = s2.run()
    counts = dict(ops.LAUNCHES)
    h2 = r2.history
    print(f"[ckpt] S2: start_step {r2.start_step}, losses {[round(h['loss'], 6) for h in h2]} "
          f"grad_norm {[round(h['grad_norm'], 4) for h in h2]}; S0's steps 4-6: losses "
          f"{[round(h['loss'], 6) for h in h0[3:]]} grad_norm "
          f"{[round(h['grad_norm'], 4) for h in h0[3:]]}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if r2.start_step != 3 or r2.steps_run != 3:
        raise AssertionError(f"S2 resumed at {r2.start_step} and ran {r2.steps_run} steps")
    if not np.array_equal(b2[0], b0[3]):
        raise AssertionError("S2's first batch is not S0's fourth")
    bit_equal = all(h2[i][k] == h0[3 + i][k] for i in range(3) for k in ("loss", "grad_norm"))
    for key in ("loss", "grad_norm"):
        if not np.allclose([h[key] for h in h2], [h[key] for h in h0[3:]], rtol=1e-6, atol=0.0):
            raise AssertionError(f"S2's {key} at steps 4-6 differs from S0's")
    print(f"[ckpt] S2's losses and grad norms at steps 4-6 equal S0's to rtol 1e-6; "
          f"bit-equal: {bit_equal}")
    _check_launches(counts, expected_train_launches(cfg, "f32", 3), "resumed training")
    del s2, r2
    torch.cuda.empty_cache()


def _elastic_sequence(session, params):
    """Run 2 steps, lose csd/1, run 2, a csd joins, run 2 (params and
    optimizer state carried across): the losses, the replans and step ms."""
    from repro_torch.api import WorkerJoined, WorkerLost
    from repro_torch.core.privacy import audit_custody

    r = session.run(params, steps=2)
    losses, parts = [h["loss"] for h in r.history], [r.history]
    compiles, replans = [session.compile_count], []
    for event in (WorkerLost(["csd/1"]), WorkerJoined("csd", 1)):
        rows = session.tune().schedule.global_rows
        res = session.apply(event)
        new_rows = session.tune().schedule.global_rows
        # the reference's rule: the step is rebuilt only when the rows change
        if res.recompiled != (new_rows != rows):
            raise AssertionError(f"{event}: recompiled={res.recompiled} with rows "
                                 f"{rows} -> {new_rows}")
        r = session.run(r.params, opt_state=r.opt_state, steps=2)
        losses += [h["loss"] for h in r.history]
        parts.append(r.history)
        compiles.append(session.compile_count)
        replans.append((type(event).__name__, rows, new_rows, res.recompiled,
                        res.dropped_shards))
        if compiles[-1] != compiles[-2] + int(res.recompiled):
            raise AssertionError(f"{event}: compile count {compiles}")
    audit = audit_custody(session.devices.custody_log)
    if any(audit.values()) or r.opt_state.step != 6:
        raise AssertionError(f"custody audit {audit}, optimizer step {r.opt_state.step}")
    return losses, parts, compiles, replans, audit


def elastic_replan(torch, ops, train_session_factory, dev):
    """Phase 24: WorkerLost then WorkerJoined between training runs, the
    smoke config on the CPU (plain versions) against the card (kernels)
    from the same weights in f32 and int8-fused, then deepseek-7b at phase
    23's full width in int8-fused on the card."""
    import copy

    rtol = {"f32": 1e-4, "int8-fused": 1e-2}       # phase 7's
    for prec in ("f32", "int8-fused"):
        kw = dict(steps=6, seq=32, precision=prec)
        cpu = train_session_factory(device="cpu", **kw)
        params, _ = cpu.init_state()
        gpu_params = _to(copy.deepcopy(params), dev)
        want, _, cpu_compiles, _, _ = _elastic_sequence(cpu, params)
        gpu = train_session_factory(device=dev, **kw)
        ops.reset_launches()
        got, _, compiles, replans, audit = _elastic_sequence(gpu, gpu_params)
        counts = dict(ops.LAUNCHES)
        print(f"[elastic] smoke {prec}: cpu={[round(x, 6) for x in want]} "
              f"gpu={[round(x, 6) for x in got]} compiles {compiles} replans {replans} "
              f"custody audit {audit} launches { {k: v for k, v in counts.items() if v} }")
        if not np.allclose(got, want, rtol=rtol[prec], atol=0.0):
            raise AssertionError(f"{prec}: losses across the events differ between CPU and card")
        if compiles != cpu_compiles:
            raise AssertionError(f"{prec}: compile counts {compiles} on the card, "
                                 f"{cpu_compiles} on the CPU")
        _check_launches(counts, expected_train_launches(gpu.model.cfg, prec, 6),
                        f"elastic {prec} training")

    session = train_session_factory(arch="deepseek-7b", device=dev, full_config=True,
                                    n_layers=CKPT_LAYERS, seq=CKPT_SEQ, steps=6,
                                    precision="int8-fused")
    cfg = session.model.cfg
    ops.reset_launches()
    losses, parts, compiles, replans, audit = _elastic_sequence(session, None)
    counts = dict(ops.LAUNCHES)
    ms = [[round(h["step_time"] * 1e3, 3) for h in part] for part in parts]
    print(f"[elastic] {cfg.name} int8-fused, {cfg.n_layers} layers, seq {CKPT_SEQ}: step ms "
          f"before the events {ms[0]}, after WorkerLost {ms[1]}, after WorkerJoined {ms[2]}; "
          f"rows {[r[1:3] for r in replans]}, compiles {compiles}, losses "
          f"{[round(x, 4) for x in losses]}, custody audit {audit}, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss across the elastic events")
    _check_launches(counts, expected_train_launches(cfg, "int8-fused", 6),
                    "full-width elastic training")
    del session
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
    for line in build_report(_build.KERNELS.build_log):
        print(f"[build] {line}")
    tensor_ops = sass_report(_build.KERNELS.out_dir, _build.nvcc_path())
    for name, (hmma, hgmma) in tensor_ops.items():
        print(f"[sass] {name}: {hmma} HMMA, {hgmma} HGMMA")
    for kernel in TENSOR_CORE_KERNELS:
        tc = [n for n in tensor_ops if kernel in n]
        if not tc or any(sum(tensor_ops[n]) == 0 for n in tc):
            raise AssertionError(f"{kernel} holds no tensor-core instruction: {tc}")

    records = kernel_checks(torch, ops, R, F, dev)
    tile_edge_checks(torch, R, dev)
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
    # the serve engine: paged decode kernels, smoke engines, deepseek-7b engine load
    torch.cuda.empty_cache()
    records += paged_kernel_checks(torch, R, dev)
    cross_device_engine(torch, ops, get_model, smoke_config, ServeSession, dev)
    engine_totals = full_width_engine(torch, ops, R, get_model, get_config, ServeSession, dev)
    # checkpoint / restart and elastic replanning at full width
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip-smoke-ckpt-"))
    try:
        checkpoint_restart(torch, ops, train_session_factory, dev, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    print(f"[ckpt] phase 23: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    elastic_replan(torch, ops, train_session_factory, dev)
    print(f"[elastic] phase 24: {time.perf_counter() - t_phase:.1f} s")
    # profiles after every timed run: a generate timed after the profiler ran
    # measured slower decode steps
    profile_train(torch, train_session_factory, dev, train_ms)
    profile_serving(torch, get_model, get_config, dev, decode_ms)
    profile_moe_serving(torch, get_model, get_config, dev, moe_ms)
    profile_recurrent_serving(torch, get_model, get_config, dev, rec_ms)
    totals = {"serving": serve_totals, "training": train_totals, "moe_serving": moe_totals,
              "recurrent_serving": rec_totals, "recurrent_training": rec_train_totals,
              "engine_serving": engine_totals}
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
