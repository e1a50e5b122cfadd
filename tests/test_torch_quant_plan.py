"""The row quantizer's routes: which kernel ``quantize_rows`` launches for a
shape is decided on the host by ``kernels/quantize.py::quantize_plan`` and
passed to the C entry, which refuses a vector route the shape does not
allow.  These run on the CPU: the kernels themselves run on the card only
(``chip_smoke.py`` phases 6 and 17 hold every route to its plain version
there, bit for bit)."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import quantize as Q

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

SOURCE = Path(Q.__file__).resolve().parent / "csrc" / "quantize.cu"
BF16, F32 = torch.bfloat16, torch.float32

PLAN_CASES = [
    # R, N, dtype, 16-byte-aligned bases, route
    (60 * 256 * 64, 64, BF16, True, "narrow"),       # rwkv6-7b's r/k/v: 8 lanes a row
    (60 * 256 * 32, 128, BF16, True, "narrow"),      # deepseek-7b's K/V: 16 lanes
    (60 * 128, 256, BF16, True, "narrow"),           # recurrentgemma-2b's K/V: a warp
    (60 * 128, 2560, F32, True, "wide"),             # its RG-LRU input: 640 pieces
    (129, 300, F32, True, "wide"),                   # 75 pieces
    (1001, 16, F32, True, "narrow"),                 # a group of 4 lanes
    (1001, 16, BF16, True, "narrow"),                # a group of 2 lanes
    (333, 24, BF16, True, "narrow"),                 # 3 pieces in a group of 4
    (5, 128, F32, True, "narrow"),                   # 512 bytes: a warp a row
    (9, 512, F32, True, "wide"),
    (777, 45, BF16, True, "scalar"),                 # 90 bytes: no 16-byte pieces
    (513, 300, BF16, True, "scalar"),                # 600 bytes
    (2, 33, F32, True, "scalar"),
    (1001, 64, BF16, False, "scalar"),               # a view one element in
    (1, 64, BF16, True, "narrow"),
    (1, 2560, F32, True, "wide"),
    (3, 4096, F32, True, "wide"),                    # 1024 pieces: the wide route's most
    (3, 4100, F32, True, "scalar"),                  # 1025 pieces
    (3, 8192, BF16, True, "wide"),
]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-{str(c[2])[6:]}-{'al' if c[3] else 'un'}")
def test_quantize_plan(case):
    R, N, dtype, aligned, route = case
    assert Q.quantize_plan(R, N, dtype, aligned) == route


@pytest.mark.parametrize("args, exc", [
    ((0, 64, BF16, True), ValueError),
    ((8, 0, BF16, True), ValueError),
    ((8, 64, torch.float16, True), TypeError),
], ids=["R=0", "N=0", "fp16"])
def test_quantize_plan_raises_on_shapes_no_route_takes(args, exc):
    with pytest.raises(exc):
        Q.quantize_plan(*args)


def _constants():
    text = re.sub(r"//[^\n]*", "", SOURCE.read_text())
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"\b([A-Z][A-Z_0-9]*)\s*=\s*(\d+)\b", text)}


def test_route_codes_and_limits_are_the_c_sources():
    """The host passes a route code; the C entry launches that route. Codes
    and the limits the host routes by must be the kernel source's."""
    c = _constants()
    assert Q.QUANT_ROUTES == {"narrow": c["ROUTE_NARROW"], "wide": c["ROUTE_WIDE"],
                              "scalar": c["ROUTE_SCALAR"]}
    assert Q.NARROW_MAX_BYTES == c["NARROW_MAX_BYTES"]
    assert Q.WIDE_MAX_PIECES == c["WIDE_THREADS"] * c["WIDE_PIECES"]


@pytest.mark.parametrize("noise", ["constant", "tensor"])
def test_wrapper_refuses_cpu_tensors(noise):
    """The wrapper launches a kernel or raises: a CPU tensor takes no route."""
    x = torch.zeros(8, 64, dtype=BF16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        Q.quantize_rows(x, 0.5 if noise == "constant" else torch.zeros(8, 64))
