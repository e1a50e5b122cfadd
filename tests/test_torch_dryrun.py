"""The port's dry run, roofline and assigned shapes against the JAX package:
``configs/shapes.py``'s stand-ins (meta tensors) for every arch x shape
against the reference's ShapeDtypeStructs, the roofline's terms and table
against the reference's on the same records (the port's card constants
patched to the reference's), ``ModelConfig.param_count(active_only=)`` for
all ten archs at published size, every op's meta route against its plain
version's shapes and dtypes, and the counting mode on sequences whose
FLOPs, bytes and peak are known in closed form.  Nothing here compiles:
the reference's cache comes from ``jax.eval_shape``.
"""
import json

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import input_specs as jax_input_specs
from repro.roofline import analysis as JA
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, applicable, input_specs
from repro_torch.kernels import fused_moe as FM
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.launch import dryrun
from repro_torch.models.api import get_model
from repro_torch.roofline import analysis as A
from repro_torch.roofline.cost import CostMode, attention_ops, attention_pairs, wkv6_ops

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    """Same leaves (the decode cache included), shapes and dtypes; every
    port leaf is a meta tensor."""
    cfg = get_config(arch)
    ok, why = applicable(cfg, SHAPES[shape])
    if not ok:
        assert "skipped" in why and shape == "long_500k"
        return
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(jax_input_specs(jax_get_config(arch), JSHAPES[shape])).items()}
    got = _flat(input_specs(cfg, SHAPES[shape]))
    assert all(t.is_meta for t in got.values())
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in got.items()} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_the_reference(arch):
    for active in (False, True):
        assert get_config(arch).param_count(active_only=active) == \
            jax_get_config(arch).param_count(active_only=active)
    moe = get_config(arch).family == "moe"
    assert (get_config(arch).param_count(active_only=True) < get_config(arch).param_count()) \
        == moe


def _records():
    """Dry-run records of each kind the table renders: train, prefill with
    collective bytes, decode, MoE (active params), skipped and error."""
    def ok(arch, shape, flops, hbm, coll=None, chips=1):
        cfg = get_config(arch)
        return {"arch": arch, "shape": shape, "mesh": "one_card", "status": "ok",
                "n_devices": chips, "flops": flops, "hbm_bytes": hbm,
                "collective_bytes": coll or {}, "params": cfg.param_count(),
                "active_params": cfg.param_count(active_only=True)}
    return [
        ok("deepseek-7b", "train_4k", 5.918e16, 6.527e14),
        ok("deepseek-7b", "prefill_32k", 2.118e16, 3.746e13, {"all-reduce": 3e11}, 4),
        ok("deepseek-7b", "decode_32k", 3.723e12, 6.203e12),
        ok("qwen3-moe-30b-a3b", "train_4k", 4.695e16, 1.051e15, {"all-to-all": 2e12}),
        ok("rwkv6-7b", "long_500k", 1.455e10, 1.566e10),
        {"arch": "deepseek-7b", "shape": "long_500k", "mesh": "one_card",
         "status": "skipped", "why": applicable(get_config("deepseek-7b"),
                                                 SHAPES["long_500k"])[1]},
        {"arch": "dbrx-132b", "shape": "train_4k", "mesh": "one_card", "status": "error",
         "error": "RuntimeError: x"},
    ]


def test_roofline_terms_and_table_match_the_reference(monkeypatch):
    for name, value in (("PEAK_FLOPS_BF16", JA.PEAK_FLOPS_BF16), ("HBM_BW", JA.HBM_BW),
                        ("NVLINK_BW", JA.ICI_BW)):
        monkeypatch.setattr(A, name, value)
    records = _records()
    for rec in records:
        got, want = A.roofline_terms(rec), JA.roofline_terms(rec)
        assert (got is None) == (want is None)
        if got is not None:
            for field in ("compute_s", "memory_s", "collective_s", "model_flops", "hlo_flops",
                          "useful_ratio", "roofline_fraction"):
                assert getattr(got, field) == pytest.approx(getattr(want, field), rel=1e-12)
            assert (got.dominant, got.row()) == (want.dominant, want.row())
    assert A.report_table(records) == JA.report_table(records)


def test_roofline_reads_the_cards_peaks(tmp_path, capsys):
    r = A.roofline_terms(_records()[0])
    assert r.compute_s == 5.918e16 / 989e12 and r.memory_s == 6.527e14 / 3.35e12
    assert r.model_flops == 6.0 * get_config("deepseek-7b").param_count() * 4096 * 256
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(_records()))
    A.main([str(path)])
    assert capsys.readouterr().out.count("\n") == 2 + 6    # head, rule, 5 ok + 1 skipped


# ---------------------------------------------------------------------------
# the ops' meta routes
# ---------------------------------------------------------------------------


def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _op_cases():
    """name -> (call, inputs on the CPU, the kernel work the meta route
    reports: {kernel: flops})."""
    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 2, 24, 4, 2, 16
    q, k, v = _randn(rng, B, S, H, D), _randn(rng, B, S, Hkv, D), _randn(rng, B, S, Hkv, D)
    qd = _randn(rng, B, 1, H, D)
    (kq, ks), (vq, vs) = (R.quantize_int8_ref(t.reshape(-1, D), 0.5) for t in (k, v))
    kq, vq = kq.view(k.shape), vq.view(v.shape)
    ks, vs = ks.view(B, S, Hkv, 1), vs.view(B, S, Hkv, 1)
    valid = torch.tensor([5, 24], dtype=torch.int32)
    P, ps = 8, 4
    kp, vp = _randn(rng, P, ps, Hkv, D), _randn(rng, P, ps, Hkv, D)
    (kpq, kps), (vpq, vps) = (R.quantize_int8_ref(t.reshape(-1, D), 0.5) for t in (kp, vp))
    kpq, vpq = kpq.view(kp.shape), vpq.view(vp.shape)
    kps, vps = kps.view(P, ps, Hkv, 1), vps.view(P, ps, Hkv, 1)
    table = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32)
    T, d, f, E, kk, C = 10, 16, 32, 4, 2, 6
    x, router = _randn(rng, T, d), _randn(rng, d, E)
    wg, wu, wo = _randn(rng, E, d, f), _randn(rng, E, d, f), _randn(rng, E, f, d)
    slot_tok, slot_gate = FM.moe_routing(x, router, kk, C)[:2]
    y = _randn(rng, E * C, d)
    r, kw, vw = _randn(rng, B, S, H, D), _randn(rng, B, S, H, D), _randn(rng, B, S, H, D)
    w, u = torch.rand(B, S, H, D), _randn(rng, H, D)
    a, xr = torch.rand(B, S, 40), _randn(rng, B, S, 40)
    att = attention_ops(B, H, S, S, D, True, 8)
    dec = 4.0 * D * B * H * S
    pdec = 4.0 * D * B * H * 3 * ps
    return {
        "quantize_int8": (lambda *t: ops.quantize_int8(*t), (q.reshape(-1, D), 0.5),
                          {"quantize_int8": 0.0}),
        "flash_attention": (lambda *t: ops.flash_attention(*t, causal=True, window=8),
                            (q, k, v), {"flash_attention": att}),
        "flash_attention_q8": (lambda *t: ops.flash_attention_q8(*t, causal=True, window=8),
                               (q, k, v), {"flash_attention_q8": att, "quantize_int8": 0.0}),
        "decode_attention": (lambda *t: ops.decode_attention(*t), (qd, k, v, valid),
                             {"decode_attention": dec}),
        "decode_attention_int8": (lambda *t: ops.decode_attention_int8(*t),
                                  (qd, kq, ks, vq, vs, valid), {"decode_attention_int8": dec}),
        "paged_decode_attention": (lambda *t: ops.paged_decode_attention(*t),
                                   (qd, kp, vp, table, valid), {"paged_decode_attention": pdec}),
        "paged_decode_attention_int8": (
            lambda *t: ops.paged_decode_attention_int8(*t),
            (qd, kpq, kps, vpq, vps, table, valid), {"paged_decode_attention_int8": pdec}),
        "fused_moe_gemm": (lambda *t: ops.fused_moe_gemm(*t),
                           (x, wg, wu, wo, slot_tok, slot_gate),
                           {"fused_moe_gemm": 6.0 * E * C * d * f}),
        "fused_moe_combine": (lambda *t: ops.fused_moe_combine(*t, T), (y, slot_tok),
                              {"fused_moe_combine": float(E * C * d)}),
        "fused_moe_mlp": (lambda *t: ops.fused_moe_mlp(*t, k=kk, capacity=C),
                          (x, router, wg, wu, wo),
                          {"fused_moe_gemm": 6.0 * E * C * d * f,
                           "fused_moe_combine": float(E * C * d)}),
        "rwkv6_scan": (lambda *t: ops.rwkv6_scan(*t), (r, kw, vw, w, u),
                       {"rwkv6_scan": wkv6_ops(B, S, H, D)}),
        "rwkv6_scan_q8": (lambda *t: ops.rwkv6_scan_q8(*t), (r, kw, vw, w, u),
                          {"rwkv6_scan_q8": wkv6_ops(B, S, H, D), "quantize_int8": 0.0}),
        "rglru_scan": (lambda *t: ops.rglru_scan(*t), (a, xr),
                       {"rglru_scan": 2.0 * xr.numel()}),
        "rglru_scan_q8": (lambda *t: ops.rglru_scan_q8(*t), (a, xr),
                          {"rglru_scan_q8": 2.0 * xr.numel(), "quantize_int8": 0.0}),
    }


def _spec(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("name", list(_op_cases()))
def test_meta_route_gives_the_plain_versions_shapes_and_dtypes(name):
    call, inputs, work = _op_cases()[name]
    want = _spec(call(*inputs))
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in inputs]
    with CostMode() as cost:
        got = call(*meta)
    assert all(t.is_meta for t in (got if isinstance(got, tuple) else (got,)))
    assert _spec(got) == want
    assert {k: v["flops"] for k, v in cost.kernels.items()} == pytest.approx(work)
    assert all(v["bytes"] > 0 for v in cost.kernels.values())
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)    # no launch on meta


def test_attention_pairs_closed_form():
    for Sq, Skv, causal, window in ((24, 24, True, 8), (24, 24, True, None), (5, 30, True, 7),
                                    (30, 30, False, None), (1, 17, True, None), (9, 9, True, 50)):
        brute = sum(sum(1 for j in range(Skv)
                        if not causal or (j <= Skv - Sq + i and j > Skv - Sq + i - (window or Skv)))
                    for i in range(Sq))
        assert attention_pairs(Sq, Skv, causal, window) == brute


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------


def test_cost_mode_tracks_the_peak_of_live_bytes():
    meta = torch.device("meta")
    with CostMode() as cost:
        a = torch.empty(1000, device=meta)          # 4,000 live
        b = torch.empty(500, device=meta)           # 6,000
        del a                                       # 2,000
        c = torch.empty(3000, device=meta)          # 14,000
        view = c.view(30, 100)
        del c                                       # the view keeps its storage
        d = view * 2                                # 26,000: the peak
        del view, d                                 # 2,000
        assert cost.live == 2000
    assert cost.peak == 26000
    assert cost.bytes == 24000                      # the product reads and writes 12,000
    assert cost.flops == 0
    held = torch.empty(250, device=meta)
    with CostMode() as cost:
        cost.track({"w": held})
        e = held + 1
        del e
    assert cost.peak == 2000 and cost.live == 1000
    del b


def test_dense_smoke_forward_flops_match_their_closed_form():
    """Every product of the dense smoke forward: Q/K/V/O and the SwiGLU MLP
    per layer, the flash kernel's live pairs, the LM head (norms, RoPE and
    the embedding gather are not products)."""
    cfg = smoke_config("deepseek-7b")
    model = get_model(cfg)
    params, _ = model.init_params(abstract=True)
    B, S = 3, 20
    d, hd, H, Hkv, ff = cfg.d_model, cfg.resolved_head_dim(), cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    with torch.no_grad(), CostMode() as cost:
        logits, _ = model.forward(params, torch.empty((B, S), dtype=torch.int32, device="meta"))
    assert logits.shape == (B, S, cfg.vocab)
    per_layer = (2 * B * S * d * hd * (H + 2 * Hkv) + 2 * B * S * H * hd * d
                 + 2 * B * S * d * ff * 3 + attention_ops(B, H, S, S, hd, True))
    assert cost.flops == cfg.n_layers * per_layer + 2 * B * S * d * cfg.vocab


# ---------------------------------------------------------------------------
# dry-run cells
# ---------------------------------------------------------------------------


def test_calibration_is_exact_for_a_dense_cell():
    """The two-point calibration (1 and 2 layers, extrapolated) gives the
    full trace's FLOPs, which are affine in depth.  Its bytes miss one term
    that is not: a layer's gradient of a stacked leaf (L, ...) is a full
    (L, ...) tensor added into the leaf's (measured 0.5% at 3 layers of
    batch 1).  The full trace is a cut cell's record (1 row, 3 layers), and
    the roofline reads its model FLOPs at that row, not the shape's 256."""
    rec = dryrun.dryrun_cell("deepseek-7b", "train_4k", batch=1, n_layers=3, verbose=False)
    cfg = get_config("deepseek-7b").with_(n_layers=3)
    cal = dryrun.calibrated_trace(cfg, SHAPES["train_4k"], 1)
    assert rec["calibration"] is None and cal["calibration"]["cycles"] == 3
    assert cal["flops"] == pytest.approx(rec["flops"], rel=1e-12)
    assert cal["bytes"] == pytest.approx(rec["hbm_bytes"], rel=1e-2)
    assert cal["argument"] == rec["memory"]["argument_size_in_bytes"]
    assert rec["flops"] > 3 * 6.0 * rec["params"] / 30 * 4096 * 0.5
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * 3    # forward + remat
    assert (rec["batch"], rec["layers"], rec["params"]) == (1, 3, cfg.param_count())
    r = A.roofline_terms(rec)
    assert r.model_flops == 6.0 * cfg.param_count() * 1 * 4096
    assert 0.5 < r.useful_ratio < 2.0


def test_roofline_reads_a_cut_records_batch():
    """A one-card cut names its rows in ``batch``: model FLOPs and the
    useful ratio count those rows; a record without one (the reference's)
    counts the shape's global batch."""
    whole = _records()[0]                                  # deepseek-7b train_4k, 256 rows
    cut = dict(whole, batch=4, flops=whole["flops"] / 64, hbm_bytes=whole["hbm_bytes"] / 64)
    a, b = A.roofline_terms(whole), A.roofline_terms(cut)
    assert b.model_flops == a.model_flops / 64 == 6.0 * whole["params"] * 4 * 4096
    assert b.useful_ratio == pytest.approx(a.useful_ratio, rel=1e-12)
    assert b.roofline_fraction == pytest.approx(a.roofline_fraction, rel=1e-12)
    decode = dict(_records()[2], batch=2)
    assert A.roofline_terms(decode).model_flops == 2.0 * decode["params"] * 2


def test_dryrun_main_writes_its_records(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "deepseek-7b", "--shape", "long_500k",
                        "--out", str(tmp_path / "skip.json")]) == 0
    (rec,) = json.loads(out.read_text())
    (skip,) = json.loads((tmp_path / "skip.json").read_text())
    assert skip["status"] == "skipped" and skip["mesh"] == "one_card"
    assert rec["status"] == "ok" and rec["mesh"] == "one_card" and rec["fits"] is True
    assert rec["collective_bytes"] == {} and rec["calibration"] is None
    cfg = get_config("rwkv6-7b")                                  # the published cell, uncut
    assert (rec["batch"], rec["layers"]) == (1, cfg.n_layers)
    assert rec["params"] == rec["active_params"] == cfg.param_count()
    # the arguments hold the bf16 weights and the recurrent state: no 524,288-row cache
    assert 2 * cfg.param_count() < rec["memory"]["argument_size_in_bytes"] \
        < 2 * cfg.param_count() + 2**30
    assert A.roofline_terms(rec).dominant == "memory"
    assert "dry-run: 1 ok, 0 skipped, 0 failed" in capsys.readouterr().out
