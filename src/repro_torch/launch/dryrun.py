"""One-card dry run: trace every (arch x shape) step on the ``meta`` device
(port of :mod:`repro.launch.dryrun`).

Nothing is allocated: params come from ``init_params(abstract=True)``, the
batch (and a decode's cache) from :func:`repro_torch.configs.shapes.input_specs`,
both meta tensors, and the step runs under
:class:`repro_torch.roofline.cost.CostMode`, which counts

* FLOPs (``torch.utils.flop_counter``; the kernels' own from their meta
  routes in :mod:`repro_torch.kernels.ops`, by the formulas of their bounds);
* the bytes each aten op reads and writes (the stand-in for XLA's ``bytes
  accessed``: torch's count is unfused, so it is larger);
* the peak of live bytes (the stand-in for ``memory_analysis``'s argument
  plus temp bytes): the weights, optimizer state, batch and cache the step
  is given, then every tensor from the op that makes it until it is freed.

The steps are the reference's: ``make_train_step`` with AdamW, ``Model.prefill``
and the serve step (``dryrun.py:199-257`` there).  Every record is one card
(``"mesh": "one_card"``, no collectives) and says whether its peak ``fits``
the card's memory.  The plain scans of the recurrent backwards loop over
time in Python, so their training cells keep the reference's two-point
calibration: the 1-cycle and 2-cycle variants are traced at full width and
FLOPs, bytes and memory extrapolated to the full depth (``calibration`` in
the record); every other cell is traced at its full depth.  The production
meshes, ``rules_overrides`` and ``zero1`` need the model axis and several
devices a card's process does not have, the rest of the second half of
ROADMAP item 19.

  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out dryrun.json
  PYTHONPATH=src python -m repro_torch.roofline.analysis dryrun.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, input_specs
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.roofline.cost import CostMode
from repro_torch.train.steps import make_serve_step, make_train_step

BYTES_NOTE = "torch's aten ops counted apart (unfused): an upper bound of the traffic"


def _cycle_len(cfg: ModelConfig) -> int:
    """Layers per repeating pattern cycle (the calibration unit)."""
    if cfg.family == "rglru":
        return len(cfg.block_pattern or ("R", "R", "A"))
    return 1


def _with_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """Full-width config with ``n`` layers (encoder and decoder for encdec)."""
    if cfg.family == "encdec":
        return cfg.with_(n_enc_layers=n, n_dec_layers=n)
    return cfg.with_(n_layers=n)


def _depth(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers if cfg.family == "encdec" else cfg.n_layers


def needs_calibration(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """Training the recurrent families runs their plain scan backwards, a
    Python loop over every step of every layer: traced at two depths."""
    return shape.kind == "train" and cfg.family in ("rwkv6", "rglru")


def run_step(model, shape: ShapeSpec, params, batch: Dict[str, Any]):
    """One step of ``shape.kind`` on its inputs, the reference's step
    functions: the train step (AdamW, lr 1e-3), ``Model.prefill`` over the
    whole sequence, or the serve step.  Returns what the step returns."""
    if shape.kind == "train":
        opt = adamw()
        return make_train_step(model, opt, lambda s: 1e-3)(params, batch.pop("opt_state"),
                                                          batch)
    with torch.no_grad():
        if shape.kind == "prefill":
            side = {k: v for k, v in batch.items() if k != "tokens"}
            return model.prefill(params, batch["tokens"], shape.seq_len, **side)
        return make_serve_step(model)(params, batch["token"], batch["cache"], batch["pos"])


def step_inputs(model, shape: ShapeSpec, batch: Optional[int], device="meta"):
    """(params, batch) for one step: meta tensors for a trace; on a card,
    ``device`` gives real ones of the same shapes (weights from seed 0,
    zero tokens), which is what a prediction is held against."""
    cfg = model.cfg
    if device == "meta":
        params, _ = model.init_params(abstract=True)
        inputs = input_specs(cfg, shape, batch)
    else:
        params, _ = model.init_params(seed=0, device=device)
        inputs = {k: (model.init_cache(batch or shape.global_batch, shape.seq_len,
                                       device=device) if k == "cache" else
                      torch.zeros(v.shape, dtype=v.dtype, device=device))
                  for k, v in input_specs(cfg, shape, batch).items()}
        if "loss_mask" in inputs:
            inputs["loss_mask"].fill_(1.0)
    if shape.kind == "train":
        inputs["opt_state"] = adamw().init(params)
    return params, inputs


def trace(cfg: ModelConfig, shape: ShapeSpec, batch: Optional[int] = None) -> CostMode:
    """Trace one step of ``cfg`` at ``shape`` on the meta device."""
    model = get_model(cfg)
    params, inputs = step_inputs(model, shape, batch)
    with CostMode() as cost:
        cost.track(params, inputs)
        out = run_step(model, shape, params, inputs)
        del out
    return cost


def full_trace(cfg: ModelConfig, shape: ShapeSpec, batch: Optional[int] = None) -> Dict[str, Any]:
    """The step traced at ``cfg``'s whole depth: its counts."""
    c = trace(cfg, shape, batch)
    return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak, "argument": c.argument_bytes,
            "kernels": c.kernels, "calibration": None}


def calibrated_trace(cfg: ModelConfig, shape: ShapeSpec,
                     batch: Optional[int] = None) -> Dict[str, Any]:
    """The reference's two-point calibration: the 1-cycle and 2-cycle
    variants traced at full width, every count extrapolated to ``cfg``'s
    depth (FLOPs are affine in depth)."""
    c = _cycle_len(cfg)
    cycles = _depth(cfg) / c
    c1 = trace(_with_layers(cfg, c), shape, batch)
    c2 = trace(_with_layers(cfg, 2 * c), shape, batch)

    def extrapolate(a: float, b: float) -> float:
        return a + (cycles - 1) * (b - a)

    return {
        "flops": extrapolate(c1.flops, c2.flops),
        "bytes": extrapolate(c1.bytes, c2.bytes),
        "peak": int(extrapolate(c1.peak, c2.peak)),
        "argument": int(extrapolate(c1.argument_bytes, c2.argument_bytes)),
        "kernels": {k: {f: extrapolate(v[f], c2.kernels[k][f]) for f in v}
                    for k, v in c1.kernels.items()},
        "calibration": {"cycle_layers": c, "cycles": cycles,
                        "flops_1": c1.flops, "flops_2": c2.flops,
                        "bytes_1": c1.bytes, "bytes_2": c2.bytes,
                        "peak_1": c1.peak, "peak_2": c2.peak},
    }


def dryrun_cell(
    arch: str,
    shape_name: str,
    *,
    batch: Optional[int] = None,
    n_layers: Optional[int] = None,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Trace one cell on one card; returns its record.  ``batch`` and
    ``n_layers`` cut it to what one card holds (the record's ``batch``,
    ``layers`` and ``params`` are the cut cell's)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": "one_card", "status": "skipped",
                "why": why}
    if n_layers is not None:
        cfg = _with_layers(cfg, n_layers)
    calibrate = needs_calibration(cfg, shape)

    t0 = time.time()
    counts = (calibrated_trace if calibrate else full_trace)(cfg, shape, batch)
    flops, hbm, peak, argument = (counts[k] for k in ("flops", "bytes", "peak", "argument"))
    elapsed = time.time() - t0

    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "one_card",
        "status": "ok",
        "n_devices": 1,
        "trace_s": round(elapsed, 1),
        "batch": batch or shape.global_batch,
        "layers": _depth(cfg),
        "flops": flops,
        "hbm_bytes": hbm,
        "hbm_bytes_note": BYTES_NOTE,
        "collective_bytes": {},
        "memory": {"argument_size_in_bytes": argument,
                   "temp_size_in_bytes": peak - argument,
                   "peak_bytes": peak},
        "fits": peak <= HBM_BYTES,
        "params": int(cfg.param_count()),
        "active_params": int(cfg.param_count(active_only=True)),
        "kernels": counts["kernels"],
        "calibration": counts["calibration"],
    }
    if verbose:
        print(f"[one_card] {arch} x {shape_name} (batch {rec['batch']}, {rec['layers']} layers): "
              f"OK ({elapsed:.1f}s trace{', calibrated' if calibrate else ''}, "
              f"{flops:.3e} flops, {hbm:.3e} B, peak {peak / 2**30:.2f} GiB, "
              f"{'fits' if rec['fits'] else 'does not fit'} {HBM_BYTES / 2**30:.2f} GiB)")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--out", default=None, help="write JSON results here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            try:
                rec = dryrun_cell(arch, shape)
            except Exception as e:
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": "one_card", "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
                print(f"[one_card] {arch} x {shape}: FAIL {type(e).__name__}: {str(e)[:200]}")
                traceback.print_exc(limit=3)
            results.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records to {args.out}")
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
