#!/usr/bin/env python3
"""Time the port's WKV-6 scan kernel in several source trees, in turn, on one
card: an A/B of two versions of ``csrc/rwkv6_scan.cu`` within one run.

    git archive <base> src/repro_torch | tar -x -C chip_scratch/base
    python3 scripts/wkv6_ab.py chip_scratch/base/src src src chip_scratch/base/src

Each tree is imported and its kernels are built in a process of its own.
For each tree it prints the median of 25 launches (CUDA events, L2 flushed
before each) of ``repro_torch.kernels.rwkv6_scan.rwkv6_scan`` on bf16 inputs
at the recurrent serving prefill shape (8, 512, 64, 64) and the recurrent
training shape (60, 256, 64, 64), and the card's name and power limit.
"""
import statistics
import subprocess
import sys

SHAPES = ((8, 512, 64, 64), (60, 256, 64, 64))


def time_tree(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    if not torch.cuda.is_available():
        raise SystemExit("wkv6_ab: no CUDA device")
    _build.KERNELS.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    out = []
    for shape in SHAPES:
        r, k, v = (torch.randn(*shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(*shape, generator=gen, device=dev) * 0.5)).bfloat16()
        u = torch.randn(shape[2], shape[3], generator=gen, device=dev)
        rwkv6_scan(r, k, v, w, u)
        torch.cuda.synchronize()
        times = []
        for _ in range(25):
            scratch.zero_()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            rwkv6_scan(r, k, v, w, u)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out.append(f"{shape}: {statistics.median(times):.4f} ms")
    print(f"{tree}: " + "; ".join(out), flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_tree(argv[1])
        return 0
    if not argv:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for tree in argv:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
