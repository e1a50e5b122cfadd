"""Three-term roofline from the dry run's records (port of
:mod:`repro.roofline.analysis`, the same formulas over the card's peaks):

    compute    = FLOPs / 989e12 FLOP/s        (H100 dense bf16)
    memory     = bytes / 3.35e12 B/s          (H100 HBM3)
    collective = wire bytes / 450e9 B/s       (NVLink 4, a direction)

A one-card record (:mod:`repro_torch.launch.dryrun`) counts its FLOPs and
bytes over a meta-device trace; its bytes are torch's unfused count, so the
memory term is an upper bound, and it has no collective bytes.  MODEL_FLOPS
= 6·N·tokens for a training step, 2·N·tokens forward only (active N for
MoE) gives the useful-compute ratio: remat recompute, the plain backwards
and padding all show up as counted / model > 1.

  PYTHONPATH=src python -m repro_torch.roofline.analysis dryrun.json
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float          # the counted FLOPs (the reference's HLO FLOPs)
    useful_ratio: float       # MODEL_FLOPS / counted FLOPs
    dominant: str
    roofline_fraction: float  # dominant-term share of the ideal (compute) time

    def row(self) -> str:
        return (
            f"| {self.arch} | {self.shape} | {self.mesh} | "
            f"{self.compute_s:.4f} | {self.memory_s:.4f} | {self.collective_s:.4f} | "
            f"{self.dominant} | {self.useful_ratio:.2f} | {self.roofline_fraction:.2f} |"
        )


def _tokens_for(rec: Dict[str, Any]) -> float:
    """Tokens processed by one step of this cell (decode: one per row), at
    the record's own batch where a one-card cut gives one."""
    s = SHAPES[rec["shape"]]
    rows = rec.get("batch", s.global_batch)
    if s.kind in ("train", "prefill"):
        return rows * s.seq_len
    return rows  # decode: 1 new token per sequence


def model_flops(kind: str, n_params: float, tokens: float) -> float:
    """6·N·tokens for a training step, 2·N·tokens forward only."""
    return (6.0 if kind == "train" else 2.0) * n_params * tokens


def roofline_terms(rec: Dict[str, Any]) -> Optional[RooflineReport]:
    if rec.get("status") != "ok":
        return None
    chips = rec["n_devices"]
    compute_s = rec["flops"] / PEAK_FLOPS_BF16
    memory_s = rec["hbm_bytes"] / HBM_BW
    collective_s = sum(rec.get("collective_bytes", {}).values()) / NVLINK_BW

    n = rec["active_params"] if rec["active_params"] else rec["params"]
    mflops = model_flops(SHAPES[rec["shape"]].kind, n, _tokens_for(rec))

    hlo = max(rec["flops"], 1.0)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total = max(terms.values())
    # the unavoidable compute time over the bottleneck time (1.0 = at the
    # compute roofline)
    ideal = mflops / (chips * PEAK_FLOPS_BF16)
    frac = ideal / total if total > 0 else 0.0
    return RooflineReport(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mflops, hlo_flops=rec["flops"],
        useful_ratio=mflops / chips / hlo,
        dominant=dominant, roofline_fraction=min(frac, 1.0),
    )


def report_table(records: List[Dict[str, Any]]) -> str:
    head = (
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "bottleneck | useful | roofline |\n"
        "|---|---|---|---|---|---|---|---|---|"
    )
    rows = []
    for rec in records:
        r = roofline_terms(rec)
        if r is not None:
            rows.append(r.row())
        elif rec.get("status") == "skipped":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | — | "
                f"skipped: {rec['why'][:40]} | — | — |"
            )
    return "\n".join([head, *rows])


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("results", help="dry-run JSON")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        records = json.load(f)
    print(report_table(records))


if __name__ == "__main__":
    main()
