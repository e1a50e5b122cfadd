"""Wire bytes of the collectives a step issues (port of
:mod:`repro.roofline.collectives`).

The reference scans XLA's partitioned HLO for collective ops.  The port
issues its collectives itself (``dist.all_reduce`` of the replicated
gradient leaves and the loss sums, ZeRO-3's ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` in :mod:`repro_torch.distributed.zero`), so each
helper notes what it issues, as ``(kind, result bytes, group size)``, into
the :func:`recording` log in force, and :func:`collective_bytes` converts a
log with the reference's ring accounting, bytes on the wire a device:

    all-reduce          2 * result * (n-1)/n     (reduce-scatter + all-gather)
    all-gather          result * (n-1)/n         (result is the gathered size)
    reduce-scatter      result * (n-1)           (operand = result * n)
    all-to-all          result * (n-1)/n
    collective-permute  result                   (pairwise)

A worker record's ``collective_bytes`` (``{kind: bytes}``, one step) is
what :func:`repro_torch.roofline.analysis.roofline_terms` reads.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

Op = Tuple[str, int, int]            # (kind, result bytes, group size)

_LOG: Optional[List[Op]] = None


@contextlib.contextmanager
def recording(log: List[Op]):
    """Append every collective noted inside the block to ``log``."""
    global _LOG
    prev, _LOG = _LOG, log
    try:
        yield log
    finally:
        _LOG = prev


def note(kind: str, result_bytes: int, group_size: int) -> None:
    """Record one collective (a no-op outside :func:`recording`)."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    if _LOG is not None:
        _LOG.append((kind, int(result_bytes), int(group_size)))


def wire_bytes(kind: str, result_bytes: int, n: int) -> int:
    """Bytes one device puts on the wire for one collective (ring schedule)."""
    if kind == "all-reduce":
        wire = 2 * result_bytes * (n - 1) / n
    elif kind == "all-gather":
        wire = result_bytes * (n - 1) / n
    elif kind == "reduce-scatter":
        wire = result_bytes * (n - 1)
    elif kind == "all-to-all":
        wire = result_bytes * (n - 1) / n
    else:                                # collective-permute
        wire = result_bytes
    return int(wire)


def collective_bytes(ops: Iterable[Op]) -> Dict[str, int]:
    """A device's wire bytes a collective kind over ``ops``."""
    out: Dict[str, int] = {}
    for kind, result, n in ops:
        out[kind] = out.get(kind, 0) + wire_bytes(kind, result, n)
    return out
