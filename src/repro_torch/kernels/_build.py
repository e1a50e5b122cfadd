"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  All sources are
compiled at once, one ``nvcc`` process each, at first use, into
``kernels/_build/<hash>/`` next to this file; the hash covers the sources and
the flags, so an edited source is rebuilt and an unchanged one is reused.
The directory is listed in ``.gitignore``.  A failed build raises with
``nvcc``'s output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (source stem, argtypes); every entry returns a cudaError_t.
SIGNATURES = {
    "repro_flash_attention_fwd": (
        "flash_attention", [P, P, P, P, I, I, I, I, I, I, I, I, I, P]),
    "repro_flash_attention_int8_fwd": (
        "flash_attention", [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]),
    "repro_quantize_rows": ("quantize", [P, P, F, P, P, I, I, I, P]),
    "repro_decode_attention": (
        "decode_attention", [P, P, P, P, P, I, I, I, I, I, I, I, P]),
    "repro_decode_attention_int8": (
        "decode_attention", [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]),
    "repro_fused_moe_gemm": ("fused_moe", [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]),
    "repro_fused_moe_combine": ("fused_moe", [P, P, P, P, P, I, I, I, I, P]),
    "repro_rwkv6_scan": ("rwkv6_scan", [P, P, P, P, P, P, P, I, I, I, I, I, I, P]),
    "repro_rwkv6_scan_int8": (
        "rwkv6_scan", [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]),
    "repro_rglru_scan": ("rglru_scan", [P, P, P, I, I, I, P]),
    "repro_rglru_scan_int8": ("rglru_scan", [P, P, P, P, I, I, I, P]),
}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


class _Kernels:
    """The loaded libraries; built once per process on first use."""

    def __init__(self):
        self._libs: Optional[Dict[str, ctypes.CDLL]] = None
        self.build_seconds: Optional[float] = None
        self.build_log: str = ""

    def build(self) -> Dict[str, ctypes.CDLL]:
        if self._libs is not None:
            return self._libs
        t0 = time.perf_counter()
        out_dir = BUILD_ROOT / source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = [s for s in sources() if not (out_dir / f"lib{s.stem}.so").exists()]
        nvcc = nvcc_path() if todo else None
        procs = []
        for src in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, tmp, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode == 0:
                os.replace(tmp, out_dir / f"lib{src.stem}.so")
            else:
                os.unlink(tmp)
                failed.append(src.name)
        self.build_log = "\n".join(logs)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n{self.build_log}")
        libs = {s.stem: ctypes.CDLL(str(out_dir / f"lib{s.stem}.so")) for s in sources()}
        for name, (stem, argtypes) in SIGNATURES.items():
            fn = getattr(libs[stem], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._libs = libs
        self.build_seconds = time.perf_counter() - t0
        return libs

    def fn(self, name: str):
        stem = SIGNATURES[name][0]
        return getattr(self.build()[stem], name)


KERNELS = _Kernels()


def call(name: str, *args) -> None:
    """Call a C entry point; raise if it reports a CUDA error."""
    err = KERNELS.fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
