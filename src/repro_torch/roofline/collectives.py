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
                grad_bytes: Iterable[int] = (), patches: int = 0) -> List[Op]:
    """The collectives one rank issues in one training step of ``cfg`` on a
    ``(data, model)`` mesh, tensor- and expert-parallel over ``model``
    (:mod:`repro_torch.distributed.tensor`), with ``rows`` of the batch on
    the rank at ``seq`` tokens (and, for a VLM, ``patches`` patch rows
    before them), under the default rules (a dim is split where the axis
    divides it): the closed form the step's :func:`recording` log is held
    to.  ``A`` is an activation all-reduce, rows x (patches + seq) x
    d_model float32.  A forward collective runs once a forward execution
    of its layer, twice under ``cfg.remat`` (the recompute), except a
    layer's last one, the split MLP's or the MoE layer's combine: it saves
    nothing for the backward, and the recompute (torch's non-reentrant
    checkpoint) stops at the last tensor the backward reads.  A backward
    collective runs once.  Gathers move ``cfg.dtype`` bytes; reduce-scatters
    and all-reduces float32.

      * an attention (dense, MoE, VLM, recurrentgemma's A layers, whisper's
        self- and cross-attention): ``A`` forward (the heads' partial sums),
        ``A`` backward (the copy-in of its input), and where the axis does
        not divide the KV heads, K and V backward (their gradients summed,
        rows x KV rows x KV heads x head dim);
      * a split MLP (dense, VLM, recurrentgemma's GeGLU, whisper's GELU
        MLP): ``A`` forward, ``A`` backward;
      * an MoE layer whose experts the axis divides: the router all-gathered
        forward and reduce-scattered backward, over ``data`` of two or more
        the routing statistics' mean (2 x E float32) forward and, at
        ``model_index`` 0 alone (the rank that sends the aux loss's
        gradient), backward, then the partial outputs ``A`` forward and the
        input's copy-in ``A`` backward;
      * an RWKV-6 layer over split ``lru`` channels: time mixing's ``wo``
        reduce-out ``A`` forward and its input's copy-in ``A`` backward;
        the mu gathers forward, one all-gather of the four vectors that mix
        r, k, v and g (4 x d_model, reduce-scattered backward) and one of
        ``mu_w`` (d_model, whose gradient is whole: the backward keeps the
        rank's slice); the decay LoRA's copy-in backward (rows x seq x
        decay_lora float32).  Channel mixing: its input's copy-in ``A``
        backward; over split FFN columns the ``wv`` reduce-out ``A``
        forward (not the layer's last: the gate's product reads it); the
        ``r`` gather forward (rows x seq x d_model; the backward keeps the
        rank's slice); one all-gather of ``mu_r`` and ``mu_k``
        (2 x d_model), reduce-scattered backward;
      * a recurrentgemma R layer over split ``lru`` channels: the ``out``
        reduce-out ``A`` forward and the input's copy-in ``A`` backward;
        under ``int8-fused`` the row absmax's max over ``model`` forward
        (rows x seq float32);
      * whisper: per encoder layer its attention and MLP at rows x n_frames
        x d_model, the encoder output's copy-in backward (at that size)
        where the axis divides the KV heads, then per decoder layer its
        self-attention, cross-attention (the KV rows are the frames) and
        MLP;
      * a split vocabulary: the embedding's ``A`` forward (at the text's
        ``seq``), the head's copy-in ``A`` backward, and the loss's max,
        sum of exponentials and target logit (rows x seq float32 each);
      * over ``data`` of two or more: every gradient of ``grad_bytes`` (the
        leaves replicated over ``data``) and the loss sums (3 float32);
      * the gradient norm's partial sum of squares of the model-sharded
        leaves over ``model`` (float32).

    A plan that also shards over ``data`` (ZeRO-3) adds its gathers,
    reduce-scatters and norm sums, which this count leaves out.
    """
    reps = 2 if cfg.remat else 1
    d = cfg.d_model
    act = rows * (seq + patches) * d * 4
    param = cfg.dtype.itemsize
    hd = cfg.resolved_head_dim()
    kv_split = cfg.n_kv_heads % model == 0
    mlp = cfg.family != "moe" and cfg.d_ff % model == 0
    ops: List[Op] = []

    def ar(nbytes, n=model, times=1):
        ops.extend([("all-reduce", nbytes, n)] * times)

    def gather(nbytes, times=reps):
        ops.extend([("all-gather", nbytes, model)] * times)

    def attention(a, kv_rows):
        ar(a, times=reps + 1)
        if not kv_split:
            ar(kv_rows * cfg.n_kv_heads * hd * 4, times=2)

    def split_mlp(a):
        if mlp:
            ar(a, times=2)

    if cfg.family == "rwkv6":
        lru = d % model == 0
        for _ in range(cfg.n_layers):
            if lru:
                ar(act, times=reps + 1)                  # time mixing
                ar(rows * seq * cfg.decay_lora * 4)
                gather(4 * d * param)
                gather(d * param)
                ops.append(("reduce-scatter", 4 * (d // model) * 4, model))
                gather(rows * seq * d * param)           # channel mixing's r, its mus
                gather((2 if mlp else 1) * d * param)
                ops.append(("reduce-scatter", (2 if mlp else 1) * (d // model) * 4, model))
                if not mlp:
                    gather(d * param)
            if lru or mlp:
                ar(act)                                  # channel mixing's copy-in
            if mlp:
                ar(act, times=reps)
    elif cfg.family == "rglru":
        from repro_torch.models.rglru import layer_kinds

        width = cfg.lru_width or d
        for kind in layer_kinds(cfg):
            if kind == "A":
                attention(act, rows * seq)
            elif width % model == 0:
                ar(act, times=reps + 1)
                if cfg.train_precision == "int8-fused":
                    ar(rows * seq * 4, times=reps)
            split_mlp(act)
    elif cfg.family == "encdec":
        enc = rows * cfg.n_frames * d * 4
        for _ in range(cfg.n_enc_layers):
            attention(enc, rows * cfg.n_frames)
            split_mlp(enc)
        if kv_split:
            ar(enc)
        for _ in range(cfg.n_dec_layers):
            attention(act, rows * seq)
            attention(act, rows * cfg.n_frames)
            split_mlp(act)
    else:
        for _ in range(cfg.n_layers):
            attention(act, rows * (seq + patches))
            if cfg.family == "moe" and cfg.n_experts % model == 0:
                E = cfg.n_experts
                ops.extend([("all-gather", d * E * param, model)] * reps)
                ops.append(("reduce-scatter", d * (E // model) * 4, model))
                if data > 1:
                    ar(2 * E * 4, data, times=reps + (model_index == 0))
                ar(act, times=2)             # the layer's last: forward once
            else:
                split_mlp(act)
    if cfg.vocab % model == 0:
        ar(rows * seq * d * 4)
        ar(act)
        ar(rows * seq * 4, times=3)
    if data > 1:
        for nbytes in grad_bytes:
            ar(nbytes, data)
        ar(12, data)
    ar(4)
    return ops
