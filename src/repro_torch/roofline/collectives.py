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


def tp_step_ops(cfg, rows: int, seq: int, model: int, *, data: int = 1, model_index: int = 0,
                grad_bytes: Iterable[int] = ()) -> List[Op]:
    """The collectives one rank issues in one training step of a dense or
    MoE ``cfg`` on a ``(data, model)`` mesh, tensor- and expert-parallel
    over ``model`` (:mod:`repro_torch.distributed.tensor`), with ``rows`` of
    the batch on the rank at ``seq``, under the default rules (a dim is
    split where the axis divides it): the closed form the step's
    :func:`recording` log is held to.  A forward all-reduce of an
    activation (``A``: rows x seq x d_model, float32) runs once a forward
    execution of its layer, twice under ``cfg.remat`` (the recompute),
    except a layer's last one, the split MLP's or the MoE layer's combine:
    it saves nothing for the backward, and the recompute (torch's
    non-reentrant checkpoint) stops at the last tensor the backward reads.
    A backward all-reduce runs once:

      * a layer's attention: ``A`` forward (the heads' partial sums), ``A``
        backward (the copy-in of its input), and where the axis does not
        divide the KV heads, K and V backward (their gradients summed);
      * a dense layer's split MLP: ``A`` forward, ``A`` backward;
      * an MoE layer whose experts the axis divides: the router all-gathered
        forward and reduce-scattered backward (float32), over ``data`` of
        two or more the routing statistics' mean (2 x E float32) forward
        and, at ``model_index`` 0 alone (the rank that sends the aux loss's
        gradient), backward, then the partial outputs ``A`` forward and the
        input's copy-in ``A`` backward;
      * a split vocabulary: the embedding's ``A`` forward, the head's
        copy-in ``A`` backward, and the loss's max, sum of exponentials and
        target logit (rows x seq float32 each);
      * over ``data`` of two or more: every gradient of ``grad_bytes`` (the
        leaves replicated over ``data``) and the loss sums (3 float32);
      * the gradient norm's partial sum of squares of the model-sharded
        leaves over ``model`` (float32).

    A plan that also shards over ``data`` (ZeRO-3) adds its gathers,
    reduce-scatters and norm sums, which this count leaves out.
    """
    reps = 2 if cfg.remat else 1
    act = rows * seq * cfg.d_model * 4
    param = cfg.dtype.itemsize
    ops: List[Op] = []

    def ar(nbytes, n=model, times=1):
        ops.extend([("all-reduce", nbytes, n)] * times)

    for _ in range(cfg.n_layers):
        ar(act, times=reps + 1)
        if cfg.family == "moe" and cfg.n_experts % model == 0:
            E = cfg.n_experts
            ops.extend([("all-gather", cfg.d_model * E * param, model)] * reps)
            ops.append(("reduce-scatter", cfg.d_model * (E // model) * 4, model))
            if data > 1:
                ar(2 * E * 4, data, times=reps + (model_index == 0))
            ar(act, times=2)             # the layer's last: forward once
        elif cfg.family != "moe" and cfg.d_ff % model == 0:
            ar(act, times=2)
        if cfg.n_kv_heads % model:
            ar(rows * seq * cfg.n_kv_heads * cfg.resolved_head_dim() * 4, times=2)
    if cfg.vocab % model == 0:
        ar(act, times=2)
        ar(rows * seq * 4, times=3)
    if data > 1:
        for nbytes in grad_bytes:
            ar(nbytes, data)
        ar(12, data)
    ar(4)
    return ops
