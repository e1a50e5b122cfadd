"""Tensor and expert parallelism over the mesh's ``model`` axis: the
collectives a Megatron-style forward writes out where the reference lets
GSPMD insert them (its ``with_logical_constraint`` points,
``repro/models/layers.py``).

A rank holds the pieces of the weights that the plan shards over ``model``
(:func:`repro_torch.distributed.sharding.arg_shardings_for_tree`): its
query heads (and KV heads, where the axis divides them), FFN columns,
vocabulary rows and experts.  It computes the piece of each product whose
weight it holds; a weight the axis does not divide is whole on every rank
and computed whole, except the query heads: a rank computes its block of
``ceil(H / m)`` of them from the whole weights (:attr:`TensorPlan.
head_block`, the reference's padded split; the last ranks hold fewer, or
none).  The activations between the products are whole on every rank of a
``model`` group:

  * :func:`copy_in` (Megatron's *f*) at the input of a column-parallel
    product: the identity forward, an all-reduce of the gradient backward
    (each rank's gradient is its heads' or columns' part);
  * :func:`reduce_out` (Megatron's *g*) at the output of a row-parallel
    product: an all-reduce of the partial sums forward, the identity
    backward.  Partial sums and gradients are reduced in float32 and
    rounded once to the activation's dtype;
  * :func:`gather_features`: a rank's feature columns of an activation
    whole along the last dim (every rank's piece in rank order), whose
    gradient is whole on every rank: the backward keeps the rank's slice,
    no collective (RWKV-6's channel-mix gate ``r`` and its decay mix);
  * :func:`row_absmax`: the max over the group of each row's absmax of a
    rank's columns (the int8 RG-LRU's whole-row scale);
  * :func:`gather_batch` / :func:`scatter_batch`: the over-model layout's
    tiled all-gather of a group's rows along the batch and its
    reduce-scatter back (the MoE layer's, where the ``batch`` rule names
    ``model``);
  * :func:`embed` and :func:`cross_entropy`: the vocabulary-parallel
    embedding (a masked gather of the rank's rows, then :func:`reduce_out`)
    and loss (the all-reduced max, sum of exponentials and target logit,
    in float32);
  * :func:`data_mean`: the mean over the ``data`` group (the MoE router's
    load statistics), whose gradient is the mean of the ranks' gradients;
  * :func:`whole_logits`: serving's logits, a rank's vocabulary columns
    gathered whole, so every rank's argmax and sampler read every column.

:func:`plan_for` reads the mesh in scope (:func:`~repro_torch.distributed.
sharding.use_mesh`) and the rule table in force into a :class:`TensorPlan`
of which products a config's forward shards; ``None`` outside a mesh with a
``model`` axis of two or more devices, where every layer runs as on one
device.  Every collective is noted in
:mod:`repro_torch.roofline.collectives`' log.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import zero
from repro_torch.distributed.sharding import (
    SHARDED_WEIGHTS, ProcessMesh, _divisible_spec, get_mesh, get_rules, heads_on_model,
    mesh_axis_sizes, spec_for,
)
from repro_torch.roofline import collectives


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the mesh in scope: its ``model`` group and
    coordinate, its ``data`` group, and whether the batch rows are split
    over ``model`` too (the over-model layout)."""

    group: Any
    size: int
    index: int
    data_group: Any
    data_size: int
    batch_over_model: bool

    @property
    def scope(self) -> zero.ZeroScope:
        """The ``model`` group as a gather scope (:class:`zero._Gather`'s)."""
        return zero.ZeroScope(None, self.group, self.size)


def model_axis() -> Optional[ModelAxis]:
    """The mesh in scope's ``model`` axis, or None outside a mesh or where
    the axis has one device."""
    mesh = get_mesh()
    if mesh is None:
        return None
    sizes = mesh_axis_sizes(mesh)
    m = sizes.get("model", 1)
    if m == 1:
        return None
    if isinstance(mesh, ProcessMesh):
        raise NotImplementedError(
            f"a model axis of {m} on a ProcessMesh: tensor parallelism needs the ranks' "
            f"process group (a DeviceMesh, launch.mesh.make_host_mesh)")
    batch = get_rules().get("batch")
    batch = (batch,) if isinstance(batch, str) else tuple(batch or ())
    data = sizes.get("data", 1)
    return ModelAxis(group=mesh.get_group("model"), size=m,
                     index=int(mesh.get_local_rank("model")),
                     data_group=mesh.get_group("data") if data > 1 else None,
                     data_size=data, batch_over_model="model" in batch)


@dataclasses.dataclass(frozen=True)
class TensorPlan:
    """Which of a config's products a rank computes a ``model`` piece of
    (``lru``: the recurrent families' channel blocks, RWKV-6's heads).
    ``heads``: the rank computes a block of the query heads, from its piece
    of the weights or, under ``pad_heads`` (the axis does not divide them),
    from the whole weights."""

    axis: ModelAxis
    heads: bool
    kv_heads: bool
    mlp: bool
    vocab: bool
    experts: bool
    n_heads: int
    n_kv_heads: int
    lru: bool = False
    pad_heads: bool = False

    @property
    def head_block(self) -> Tuple[int, int]:
        """``[start, stop)`` of the rank's query heads: ``ceil(H / m)`` a
        rank in rank order, the last ranks fewer or none (every head where
        the plan does not split them)."""
        if not self.heads:
            return 0, self.n_heads
        per = -(-self.n_heads // self.axis.size)
        start = min(self.axis.index * per, self.n_heads)
        return start, min(start + per, self.n_heads)


def _names_model(spec) -> bool:
    part = spec[0] if spec else None
    return "model" in ((part,) if isinstance(part, str) else tuple(part or ()))


def _over_model(name: str, size: int) -> bool:
    """Whether a weight dim of logical ``name`` and whole ``size`` is split
    over ``model`` under the rule table in force (as the plan lays it out)."""
    return _names_model(_divisible_spec(spec_for((name,), get_rules()), (size,), get_mesh()))


def lru_width(cfg) -> int:
    """The whole width of ``cfg``'s ``lru`` axis (0 where it has none)."""
    if cfg.family == "rwkv6":
        return cfg.d_model
    if cfg.family == "rglru":
        return cfg.lru_width or cfg.d_model
    return 0


def plan_for(cfg) -> Optional[TensorPlan]:
    """The :class:`TensorPlan` of ``cfg`` on the mesh in scope, or None.
    Query heads that the rules put on ``model`` but the axis does not
    divide are a padded split (``pad_heads``); rules that keep them whole,
    and an ``lru`` split that cuts an RWKV head, raise
    ``NotImplementedError``."""
    axis = model_axis()
    if axis is None:
        return None
    attention = cfg.family != "rwkv6"
    if attention and not heads_on_model(get_rules()):
        raise NotImplementedError(
            f"{cfg.name} on a model axis of {axis.size} whose rules keep the query heads "
            f"whole: {SHARDED_WEIGHTS}")
    split = attention and _over_model("heads", cfg.n_heads)
    pad = attention and not split
    width = lru_width(cfg)
    lru = width > 0 and _over_model("lru", width)
    if lru and cfg.family == "rwkv6" and (width // axis.size) % cfg.rwkv_head_dim:
        raise NotImplementedError(
            f"{cfg.name}'s {width} channels over a model axis of {axis.size} are not whole "
            f"heads of {cfg.rwkv_head_dim}: {SHARDED_WEIGHTS}")
    return TensorPlan(axis=axis, heads=split or pad,
                      kv_heads=attention and _over_model("kv_heads", cfg.n_kv_heads),
                      mlp=_over_model("mlp", cfg.d_ff) and cfg.family != "moe",
                      vocab=_over_model("vocab", cfg.vocab),
                      experts=bool(cfg.n_experts) and _over_model("experts", cfg.n_experts),
                      n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, lru=lru, pad_heads=pad)


def logical_sizes_of(cfg, tp: Optional[TensorPlan] = None) -> Dict[str, int]:
    """The whole sizes of ``cfg``'s sharded activation axes (what
    :func:`~repro_torch.distributed.sharding.with_logical_constraint`
    holds a rank's pieces to).  The recurrent families' channel-block
    activations are named ``lru``, the weights' axis (the reference names
    them ``act_mlp``, which the port keeps for the FFN columns).  Padded
    query heads (``tp.pad_heads``) are a block of the rank's, which no
    even split describes: ``act_heads`` is left out."""
    sizes = {"act_heads": cfg.n_heads, "act_kv_heads": cfg.n_kv_heads, "act_vocab": cfg.vocab}
    if tp is not None and tp.pad_heads:
        del sizes["act_heads"]
    if cfg.family == "moe":
        sizes["act_experts"] = cfg.n_experts
    else:
        sizes["act_mlp"] = cfg.d_ff
    if lru_width(cfg):
        sizes["lru"] = lru_width(cfg)
    return sizes


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _sum(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The float32 sum over ``group`` of ``t``, rounded once to its dtype."""
    return zero.all_reduce(t.to(torch.float32, copy=True), group, size).to(t.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis.group, ctx.axis.size), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis.group, axis.size)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Identity forward; the gradient summed over the ``model`` group."""
    return _CopyIn.apply(x, axis)


def reduce_out(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The partial sums ``x`` summed over the ``model`` group; identity backward."""
    return _ReduceOut.apply(x, axis)


def _scatter(full: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return zero.reduce_scatter(full, 0, axis.group, axis.size).to(full.dtype)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return zero.all_gather(x, 0, axis.group, axis.size)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.axis), None


class _ScatterBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return zero.all_gather(g, 0, ctx.axis.group, ctx.axis.size), None


def gather_batch(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The ``model`` group's rows, every rank's ``x`` along dim 0 in rank
    order; the gradient comes back reduce-scattered (summed)."""
    return _GatherBatch.apply(x, axis)


def scatter_batch(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """This rank's rows of the sum over the ``model`` group of ``x`` (a
    reduce-scatter along dim 0); the gradient comes back all-gathered."""
    return _ScatterBatch.apply(x, axis)


def gather_weight(w: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """A ``model``-sharded weight whole along ``dim`` (every rank's piece in
    rank order); its gradient comes back reduce-scattered."""
    return zero._Gather.apply(w, dim, axis.scope)


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return zero.all_gather(x, x.dim() - 1, axis.group, axis.size)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.axis.index, ctx.width
        return g[..., i * n:(i + 1) * n], None


def gather_features(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Every rank's feature columns of ``x`` (its last dim) in rank order.
    The gradient of the whole is whole on every rank (it flows from whole
    activations), so the backward keeps the rank's slice of it and moves
    nothing."""
    return _GatherFeatures.apply(x, axis)


@torch.no_grad()
def row_absmax(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The absmax of each row of the whole (..., W) of which ``x`` holds
    this rank's columns: the max over the group of the ranks' row absmax,
    float32 (..., 1)."""
    return _all_reduce_max(x.detach().float().abs().amax(dim=-1, keepdim=True).contiguous(),
                           axis)


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return zero.all_reduce(x.clone(), group, size) / size

    @staticmethod
    def backward(ctx, g):
        return zero.all_reduce(g.clone(), ctx.group, ctx.size) / ctx.size, None, None


def data_mean(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The mean of ``x`` over the ``data`` group (itself on one data rank):
    every rank's objective reads it, so its gradient is the ranks' mean."""
    if axis.data_size == 1:
        return x
    return _DataMean.apply(x, axis.data_group, axis.data_size)


# ---------------------------------------------------------------------------
# Vocabulary parallelism
# ---------------------------------------------------------------------------


@torch.no_grad()
def whole_logits(y: torch.Tensor, tp: Optional[TensorPlan]) -> torch.Tensor:
    """Serving's logits whole from this rank's vocabulary columns ``y``
    (..., V/m) under ``tp``: one all-gather along the last dim, every rank's
    columns in rank order, the same bytes on every rank; ``y`` itself on one
    device or where the plan keeps the vocabulary whole."""
    if tp is None or not tp.vocab:
        return y
    return zero.all_gather(y, y.dim() - 1, tp.axis.group, tp.axis.size)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype,
          axis: ModelAxis) -> torch.Tensor:
    """Rows of the whole embedding from this rank's rows ``table`` (V/m, d):
    each token's row on the rank that holds it, zero elsewhere, summed over
    the group (one nonzero term: exact)."""
    rows = table.shape[0]
    local = tokens.long() - axis.index * rows
    mine = (local >= 0) & (local < rows)
    got = table.to(dtype)[local.clamp(0, rows - 1)]
    return reduce_out(torch.where(mine[..., None], got, torch.zeros((), dtype=dtype,
                                                                    device=got.device)), axis)


def _all_reduce_max(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.group)
    collectives.note("all-reduce", t.numel() * t.element_size(), axis.size)
    return t


class _VocabCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, axis):
        lf = logits.float()
        rows = lf.shape[-1]
        mx = _all_reduce_max(lf.amax(dim=-1), axis)
        se = zero.all_reduce(torch.exp(lf - mx[..., None]).sum(dim=-1), axis.group, axis.size)
        lse = mx + torch.log(se)
        local = labels.long() - axis.index * rows
        mine = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        gold = torch.gather(lf, -1, local[..., None])[..., 0]
        gold = zero.all_reduce(torch.where(mine, gold, 0.0), axis.group, axis.size)
        ctx.save_for_backward(logits, lse, local, mine)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, mine = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, local[..., None], -mine[..., None].float())
        return (p * g[..., None]).to(logits.dtype), None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Per-token CE from this rank's vocabulary columns of the logits
    (B, S, V/m): ``logsumexp - target logit`` over the whole vocabulary, in
    float32, the same value on every rank of the group."""
    return _VocabCrossEntropy.apply(logits, labels, axis)
