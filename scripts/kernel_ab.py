#!/usr/bin/env python3
"""Time one of the port's kernels in several source trees, in turn, on one
card: an A/B of two versions of a ``csrc/`` source within one run.

    mkdir -p chip_scratch/base && git archive <base> src/repro_torch | tar -x -C chip_scratch/base
    python3 scripts/kernel_ab.py KERNEL chip_scratch/base/src src src chip_scratch/base/src

Each tree is imported and its kernels are built in a process of its own.
For each tree it prints the median of 25 launches (CUDA events, L2 flushed
before each) at the shapes of the chosen KERNEL; first the card's name and
power limit.  KERNEL is one of:

  wkv6    ``rwkv6_scan`` on bf16 inputs at the recurrent serving prefill
          shape (8, 512, 64, 64) and the recurrent training shape
          (60, 256, 64, 64), and ``rwkv6_scan_int8`` (bf16 out, the
          training quantizer's int8 r/k/v) at the training shape;
  decode  ``decode_attention`` and ``decode_attention_int8`` (bf16 q) at the
          shapes ``chip_smoke.py`` times them at: MHA (8 rows, 32 heads of
          128, 577-row cache), GQA-8 (32 heads over 4) and MQA-10 at D = 256
          (10 heads over 1, 2048-row cache), with ragged valid lengths;
  flash   ``flash_attention_fwd`` on bf16 inputs at the five shapes
          ``chip_smoke.py`` times it at: dense prefill (8, 512, 32, 128),
          MoE prefill GQA-8 (32 heads over 4), training (60, 256, 32, 128),
          all causal; recurrent training (60, 128, 10 over 1, 256) and
          recurrentgemma's prompt of 3072 (8 rows, 10 over 1, 256), causal
          with a window of 2048;
  flash8  ``flash_attention_int8_fwd`` on bf16 queries over int8 K/V (the
          training quantizer's rows) at ``chip_smoke.py``'s two shapes:
          phase 6's training shape (60, 256, 32, 128), causal, and phase
          17's recurrent training shape (60, 128, 10 over 1, 256), causal
          with a window of 2048;
  quant   the row quantizer (``quantize_rows``, noise 0.5) at the training
          path's four shapes: rows of 64 bf16 (rwkv6-7b's r/k/v, 983,040
          rows), of 128 bf16 (deepseek-7b's K/V, 491,520), of 256 bf16
          (recurrentgemma-2b's K/V, 7,680) and of 2560 f32 (its RG-LRU
          input, 7,680), each with the route the tree's wrapper names where
          it names one;
  rglru   ``rglru_scan`` at the recurrent serving prefill shape (8, 512,
          2560) and the recurrent training shape (60, 128, 2560), and
          ``rglru_scan_int8`` (the training quantizer's int8 x) at the
          training shape;
  moe     ``fused_moe_gemm`` and ``fused_moe_combine`` (bf16) at
          ``chip_smoke.py`` phase 9's prefill (T 4096, C 384) and decode
          (T 8, C 8) shapes of qwen3-moe-30b-a3b, one layer's experts and
          router and the slot tables (``moe_routing``) from seed 0: each op's
          time, the GEMM's gate/up and down kernels apart (``torch.profiler``,
          mean of 25), the route the tree's wrappers name where they name one,
          and the GEMM's error against its plain version over seeds 0-5 as a
          share of phase 9's tolerance (one bf16 ulp of the largest output).
"""
import statistics
import subprocess
import sys
from pathlib import Path

WKV6_SHAPES = ((8, 512, 64, 64), (60, 256, 64, 64))
VALID_577 = [576, 1, 300, 513, 576, 0, 450, 520]
VALID_2048 = [2048, 1, 1000, 2047, 577, 0, 1500, 2048]
# label: (B, H, Hkv, D, cache rows, valid lengths)
DECODE_SHAPES = {
    "MHA": (8, 32, 32, 128, 577, VALID_577),
    "GQA-8": (8, 32, 4, 128, 577, VALID_577),
    "D=256": (8, 10, 1, 256, 2048, VALID_2048),
}


def time_wkv6(torch, median_ms, gen, dev):
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_int8

    out = []
    for shape in WKV6_SHAPES:
        r, k, v = (torch.randn(*shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(*shape, generator=gen, device=dev) * 0.5)).bfloat16()
        u = torch.randn(shape[2], shape[3], generator=gen, device=dev)
        out.append(f"{shape}: {median_ms(lambda: rwkv6_scan(r, k, v, w, u)):.4f} ms")
        if shape == WKV6_SHAPES[-1]:
            (rq, rs), (kq, ks), (vq, vs) = (R.quantize_int8_ref(t, 0.5) for t in (r, k, v))
            ms = median_ms(lambda: rwkv6_scan_int8(rq, rs, kq, ks, vq, vs, w, u, torch.bfloat16))
            out.append(f"int8 {shape}: {ms:.4f} ms")
    return out


def time_decode(torch, median_ms, gen, dev):
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8

    out = []
    for label, (B, H, Hkv, D, rows, valid) in DECODE_SHAPES.items():
        q = torch.randn(B, 1, H, D, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, rows, Hkv, D, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        native = median_ms(lambda: decode_attention(q, k, v, vl))
        int8 = median_ms(lambda: decode_attention_int8(q, kq, ks, vq, vs, vl))
        out.append(f"{label} {native:.4f} / int8 {int8:.4f} ms")
    return out


# label: (B, S, H, Hkv, D, window); all causal
FLASH_SHAPES = {
    "dense": (8, 512, 32, 32, 128, None),
    "MoE GQA-8": (8, 512, 32, 4, 128, None),
    "training": (60, 256, 32, 32, 128, None),
    "RT D=256": (60, 128, 10, 1, 256, 2048),
    "RS D=256 S=3072": (8, 3072, 10, 1, 256, 2048),
}


def time_flash(torch, median_ms, gen, dev):
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    out = []
    for label, (B, S, H, Hkv, D, window) in FLASH_SHAPES.items():
        q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        ms = median_ms(lambda: flash_attention_fwd(q, k, v, causal=True, window=window))
        out.append(f"{label} {ms:.4f} ms")
    return out


# label: (B, S, H, Hkv, D, window); all causal
FLASH8_SHAPES = {
    "training": (60, 256, 32, 32, 128, None),
    "RT D=256": (60, 128, 10, 1, 256, 2048),
}


def time_flash8(torch, median_ms, gen, dev):
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_int8_fwd

    out = []
    for label, (B, S, H, Hkv, D, window) in FLASH8_SHAPES.items():
        q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        (kq, ks), (vq, vs) = (R.quantize_int8_ref(
            torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16(), 0.5)
            for _ in range(2))
        ms = median_ms(lambda: flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=True,
                                                        window=window))
        out.append(f"{label} {ms:.4f} ms")
    return out


# label: (R, N, dtype name)
QUANT_SHAPES = {
    "rows of 64 bf16": (983040, 64, "bfloat16"),
    "rows of 128 bf16": (491520, 128, "bfloat16"),
    "rows of 256 bf16": (7680, 256, "bfloat16"),
    "rows of 2560 f32": (7680, 2560, "float32"),
}
RGLRU_SHAPES = {"RS": (8, 512, 2560), "RT": (60, 128, 2560)}


def time_quant(torch, median_ms, gen, dev):
    from repro_torch.kernels import quantize as Q

    out = []
    for label, (R_, N, dtype) in QUANT_SHAPES.items():
        x = torch.randn(R_, N, generator=gen, device=dev).to(getattr(torch, dtype))
        route = (Q.quantize_plan(R_, N, x.dtype, True) if hasattr(Q, "quantize_plan") else "-")
        ms = median_ms(lambda: Q.quantize_rows(x, 0.5))
        out.append(f"{label} {ms:.4f} ms (route {route})")
        del x
    return out


def time_rglru(torch, median_ms, gen, dev):
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_int8

    out = []
    for label, shape in RGLRU_SHAPES.items():
        a = torch.rand(*shape, generator=gen, device=dev) * 0.499 + 0.5
        x = torch.randn(*shape, generator=gen, device=dev)
        out.append(f"{label} {shape} {median_ms(lambda: rglru_scan(a, x)):.4f} ms")
        if label == "RT":
            xq, xs = R.quantize_int8_ref(x, 0.5)
            ms = median_ms(lambda: rglru_scan_int8(a, xq, xs))
            out.append(f"int8 {label} {ms:.4f} ms")
        del a, x
    return out


def time_moe(torch, median_ms, gen, dev):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import kernel_ms

    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_moe as FM
    from repro_torch.kernels import ref as R
    from repro_torch.models.moe import expert_capacity

    cfg = get_config("qwen3-moe-30b-a3b")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_token
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev).zero_
    groups = {"gate/up": ("moe_gate_up",), "down": ("moe_down",)}

    def layer(seed, T, C):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)

        def rand(*shape, std=1.0):
            return (torch.randn(*shape, generator=g, device=dev) * std).bfloat16()

        wg, wu = rand(E, d, f, std=d ** -0.5), rand(E, d, f, std=d ** -0.5)
        wo = rand(E, f, d, std=f ** -0.5)
        router = torch.randn(d, E, generator=g, device=dev) * d ** -0.5
        x = rand(T, d)
        slot_tok, slot_gate = FM.moe_routing(x, router, k, C)[:2]
        return x, wg, wu, wo, slot_tok, slot_gate

    out = []
    for label, T in (("prefill", 4096), ("decode", 8)):
        C = expert_capacity(T, E, k, cfg.capacity_factor)
        x, wg, wu, wo, slot_tok, slot_gate = layer(0, T, C)
        gemm = lambda: FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)  # noqa: E731
        y = gemm()
        live = slot_tok[:, 0] < T
        n_exp = int(live.view(E, C).any(dim=1).sum())
        split = kernel_ms(torch, gemm, flush, groups)
        route = (FM.gemm_route(T, d, f, E, C, x.dtype) if hasattr(FM, "gemm_route")
                 else "-")
        croute = (FM.combine_route(E * C, T, d) if hasattr(FM, "combine_route") else "-")
        shares = []
        for seed in range(6):
            args = layer(seed, T, C) if seed else (x, wg, wu, wo, slot_tok, slot_gate)
            want = R.fused_moe_gemm_ref(*args).float()
            err = (FM.fused_moe_gemm(*args).float() - want).abs().max().item()
            shares.append(err / (want.abs().max().item() * 2.0 ** -7))
            del args, want
        out.append(
            f"{label} ({int(live.sum())} live slots, {n_exp} experts) gemm "
            f"{median_ms(gemm):.4f} ms (route {route}; gate/up "
            f"{split['gate/up']:.4f}, down {split['down']:.4f}; err/tol over seeds "
            f"{' '.join(f'{r:.3f}' for r in shares)}), combine "
            f"{median_ms(lambda: FM.fused_moe_combine(y, slot_tok, T)):.4f} ms (route {croute})")
        del x, wg, wu, wo, slot_tok, slot_gate, y, live
    return out


KERNELS = {"wkv6": time_wkv6, "decode": time_decode, "flash": time_flash,
           "flash8": time_flash8, "moe": time_moe, "quant": time_quant, "rglru": time_rglru}


def time_tree(kernel: str, tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    _build.KERNELS.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(25):
            scratch.zero_()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    print(f"{tree}: " + "; ".join(KERNELS[kernel](torch, median_ms, gen, dev)), flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        time_tree(argv[1], argv[2])
        return 0
    if len(argv) < 2 or argv[0] not in KERNELS:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for tree in argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", argv[0], tree], check=True,
                       timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
