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
        rows x KV rows x KV heads x head dim); where it does not divide the
        query heads (a padded split of whole weights), the gradients of
        ``wq`` and ``wo`` (and ``bq``) backward, whole, float32;
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
    pad = cfg.n_heads % model != 0
    q_bias = cfg.qkv_bias or cfg.family == "encdec"
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
        if pad:
            ar(d * cfg.n_heads * hd * 4, times=2)
            if q_bias:
                ar(cfg.n_heads * hd * 4)

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


def tp_serve_ops(cfg, plan, batch: int, prompt: int, steps: int, *,
                 patches: int = 0) -> List[Op]:
    """The collectives one rank issues serving ``cfg`` under ``plan`` (a
    :class:`~repro_torch.distributed.sharding.ShardingPlan` on a (data,
    model) mesh, its rules the defaults but for ``lru``): one prefill of
    ``prompt`` tokens (none at 0; a VLM's ``patches`` rows before them,
    whisper's encoder over ``cfg.n_frames``), then ``steps`` decode steps,
    over the ``batch`` rows of the rank's data group.  The closed form a
    serving run's :func:`recording` log is held to, as :func:`tp_step_ops`
    is a training step's.  Serving runs forward only, so every copy-in is
    free; ``A`` is an activation all-reduce, batch x tokens x d_model
    float32:

      * an attention: ``A`` (the heads' partial sums; a padded split of
        query heads the axis does not divide joins it whole, a rank with
        no heads adding zeros);
      * a split MLP: ``A``;
      * an MoE layer whose experts the axis divides: the router's
        all-gather (d_model x E, the weights' dtype), then ``A`` (serving
        computes no router loss, so no ``data`` statistics);
      * an RWKV-6 layer over split ``lru`` channels: time mixing's mu
        gathers (4 x d_model and d_model), its ``wo`` ``A``, channel
        mixing's mu gathers (2 x d_model over split FFN columns, else two
        of d_model) and its gate r's gather (batch x tokens x d_model); a
        decode step gathers the layer's two shifts and its seven mu
        vectors in one all-gather instead ((2 x batch + 7) x d_model);
        over split FFN columns, ``wv``'s ``A``;
      * a recurrentgemma R layer over split ``lru`` channels: ``out``'s
        ``A``, and under ``int8-fused`` the prefill scan's row absmax
        (batch x tokens float32);
      * whisper's prefill: per encoder layer its attention and MLP at batch
        x n_frames x d_model, then the decoder's self-attention,
        cross-attention and MLP a layer;
      * a split vocabulary: the embedding's ``A`` (at the text's tokens)
        and the last position's logits gathered whole (batch x vocab, the
        activations' dtype).
    """
    from repro_torch.distributed.sharding import mesh_axis_sizes

    model = mesh_axis_sizes(plan.mesh).get("model", 1)
    if model == 1:
        return []
    d, item = cfg.d_model, cfg.dtype.itemsize
    mlp = cfg.family != "moe" and cfg.d_ff % model == 0
    lru_rule = plan.rules.get("lru")
    lru = "model" in ((lru_rule,) if isinstance(lru_rule, str) else tuple(lru_rule or ())) \
        and cfg.family in ("rwkv6", "rglru") and (cfg.lru_width or d) % model == 0
    ops: List[Op] = []

    def ar(nbytes, times=1):
        ops.extend([("all-reduce", nbytes, model)] * times)

    def gather(nbytes):
        ops.append(("all-gather", nbytes, model))

    def split_mlp(a):
        if mlp:
            ar(a)

    def forward(seq: int, extra: int, decode: bool):
        act = batch * (seq + extra) * d * 4
        if cfg.family == "rwkv6":
            for _ in range(cfg.n_layers):
                if lru:
                    if decode:
                        gather((2 * batch + 7) * d * item)
                    else:
                        gather(4 * d * item)
                        gather(d * item)
                        gather((2 if mlp else 1) * d * item)
                        if not mlp:
                            gather(d * item)
                    ar(act)
                    gather(batch * seq * d * item)
                split_mlp(act)
        elif cfg.family == "rglru":
            from repro_torch.models.rglru import layer_kinds

            for kind in layer_kinds(cfg):
                if kind == "A":
                    ar(act)
                elif lru:
                    ar(act)
                    if not decode and cfg.train_precision == "int8-fused":
                        ar(batch * seq * 4)
                split_mlp(act)
        elif cfg.family == "encdec":
            if not decode:
                enc = batch * cfg.n_frames * d * 4
                for _ in range(cfg.n_enc_layers):
                    ar(enc)
                    split_mlp(enc)
            for _ in range(cfg.n_dec_layers):
                ar(act, times=2)
                split_mlp(act)
        else:
            for _ in range(cfg.n_layers):
                ar(act)
                if cfg.family == "moe" and cfg.n_experts % model == 0:
                    gather(d * cfg.n_experts * item)
                    ar(act)
                else:
                    split_mlp(act)
        if cfg.vocab % model == 0:
            ar(batch * seq * d * 4)
            gather(batch * cfg.vocab * item)

    if prompt:
        forward(prompt, patches, decode=False)
    for _ in range(steps):
        forward(1, 0, decode=True)
    return ops
