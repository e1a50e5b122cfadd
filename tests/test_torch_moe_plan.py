"""The MoE kernels' routes: which kernels ``fused_moe_gemm`` and
``fused_moe_combine`` run at a shape is decided on the host by
``kernels/fused_moe.py::gemm_route`` / ``combine_route`` and passed to the C
entries.  These run on the CPU: the kernels themselves run on the card only
(``chip_smoke.py`` phase 9 holds every route to its plain version there)."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import fused_moe as FM
from repro_torch.models.moe import expert_capacity

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each

SOURCE = Path(FM.__file__).resolve().parent / "csrc" / "fused_moe.cu"
BF16, F32 = torch.bfloat16, torch.float32


def _moe_shape(arch, T):
    cfg = get_config(arch)
    E, k = cfg.n_experts, cfg.experts_per_token
    return T, cfg.d_model, cfg.d_ff, E, expert_capacity(T, E, k, cfg.capacity_factor)


ROUTE_CASES = [
    # (T, d, f, E, C), dtype, route
    (_moe_shape("qwen3-moe-30b-a3b", 4096), BF16, "tc_prefill"),     # phase 9 prefill, C 384
    (_moe_shape("qwen3-moe-30b-a3b", 8), BF16, "tc_decode"),         # phase 9 decode, C 8
    ((4096, 2048, 768, 128, 128), BF16, "tc_prefill"),                # phase 9 overflow
    (_moe_shape("qwen3-moe-30b-a3b", 8), F32, "fma"),                 # the f32 parity runs
    (_moe_shape("qwen3-moe-30b-a3b", 4096), F32, "fma"),
    (_moe_shape("dbrx-132b", 4096), BF16, "tc_prefill"),              # f 10,752
    (_moe_shape("dbrx-132b", 8), BF16, "tc_prefill"),                 # C rounds up to 128
    ((8, 6144, 10752, 16, 4), BF16, "tc_decode"),                     # dbrx's f at C 4
    ((8, 2048, 768, 128, 16), BF16, "tc_decode"),                     # one A fragment
    ((8, 2048, 768, 128, 17), BF16, "tc_prefill"),
    ((8, 256, 128, 256, 8), BF16, "tc_decode"),
    ((8, 256, 128, 300, 8), BF16, "tc_prefill"),                      # more experts than it lists
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: f"{c[0]}-{str(c[1])[6:]}")
def test_gemm_route(case):
    shape, dtype, route = case
    assert FM.gemm_route(*shape, dtype) == route


def test_phase9_capacities_are_the_ones_routed():
    assert _moe_shape("qwen3-moe-30b-a3b", 4096)[-1] == 384
    assert _moe_shape("qwen3-moe-30b-a3b", 8)[-1] == 8
    assert _moe_shape("dbrx-132b", 8)[-1] == 128


@pytest.mark.parametrize("args, exc", [
    ((8, 40, 768, 128, 8, BF16), NotImplementedError),       # d not a multiple of 16
    ((8, 2048, 100, 128, 8, BF16), NotImplementedError),     # f not a multiple of 16
    ((8, 2048, 768, 128, 8, torch.float16), TypeError),
    ((8, 2048, 768, 128, 0, BF16), ValueError),
    ((0, 2048, 768, 128, 8, F32), ValueError),
], ids=["d", "f", "fp16", "C=0", "T=0"])
def test_gemm_route_raises_on_shapes_no_route_takes(args, exc):
    with pytest.raises(exc):
        FM.gemm_route(*args)


@pytest.mark.parametrize("S, T, d, route", [
    (128 * 8, 8, 2048, "scan"),              # phase 9 decode
    (128 * 384, 4096, 2048, "two_pass"),     # phase 9 prefill
    (128 * 128, 4096, 2048, "two_pass"),     # phase 9 overflow
    (16 * 128, 8, 6144, "scan"),             # dbrx decode
    (64, 2, 32, "scan"),
    (FM.SCAN_MAX, 1, 4, "scan"),
    (FM.SCAN_MAX, 2, 4, "two_pass"),
])
def test_combine_route(S, T, d, route):
    assert FM.combine_route(S, T, d) == route


@pytest.mark.parametrize("args, exc", [
    ((64, 2, 30), NotImplementedError), ((0, 2, 32), ValueError), ((64, 0, 32), ValueError),
])
def test_combine_route_raises_on_shapes_no_route_takes(args, exc):
    with pytest.raises(exc):
        FM.combine_route(*args)


def _constants():
    text = re.sub(r"//[^\n]*", "", SOURCE.read_text())
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"\b([A-Z][A-Z_0-9]*)\s*=\s*(\d+)\b", text)}


def test_route_codes_and_limits_are_the_c_sources():
    """The host passes a route code; the C entry launches that route. Codes
    and the limits the host routes by must be the kernel source's."""
    c = _constants()
    assert FM.GEMM_ROUTES == {"fma": c["ROUTE_FMA"], "tc_prefill": c["ROUTE_TC_PREFILL"],
                              "tc_decode": c["ROUTE_TC_DECODE"]}
    assert FM.COMBINE_ROUTES == {"scan": c["COMBINE_SCAN"], "two_pass": c["COMBINE_TWO_PASS"]}
    assert (FM.DECODE_MAX_C, FM.DECODE_MAX_E, FM.MAX_K) == (c["MAX_C"], c["MAX_E"], c["MAX_K"])


@pytest.mark.parametrize("op", ["gemm", "combine"])
def test_wrappers_refuse_cpu_tensors(op):
    """The wrappers launch a kernel or raise: a CPU tensor takes no route."""
    x = torch.zeros(8, 32, dtype=BF16)
    slot_tok = torch.full((16, 1), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "gemm":
            w = torch.zeros(2, 32, 32, dtype=BF16)
            FM.fused_moe_gemm(x, w, w, w, slot_tok, torch.zeros(16, 1))
        else:
            FM.fused_moe_combine(torch.zeros(16, 32, dtype=BF16), slot_tok, 8)
