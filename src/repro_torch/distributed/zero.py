"""ZeRO-3 over the ``data`` axis: the gathers and scatters of a plan that
shards weights over ``data`` (the configs' ``fsdp=True``).

The reference has no such module: GSPMD inserts these collectives where a
``data``-sharded weight meets a replicated activation.  The port's models
are functional trees, so it writes them out:

  * :class:`_Gather` is the autograd op of one leaf: its forward is
    ``dist.all_gather_into_tensor`` of the rank's shard along its sharded
    dim, over the ``data`` group; its backward is
    ``dist.reduce_scatter_tensor`` (sum) of the whole gradient back to the
    shard, in float32.  So a sharded leaf's gradient arrives already summed
    over the ranks, and the step reduces only the replicated leaves.
  * :func:`gather` maps a subtree of the parameters to whole tensors by
    their :class:`~repro_torch.distributed.sharding.Layout`\\ s.  The models
    call it where a layer takes its weights (``dense._run_layer``, inside
    the ``checkpoint``\\ ed body, so the backward's recompute gathers again)
    and where the embedding and the head are used.  Outside a
    :func:`zero3` scope it is the identity, so a single-process or
    replicated step runs as before; the whole tensors live only as long
    as the layer's autograd needs them.

On a (data, model) mesh the group is the rank's ``data`` subgroup
(``mesh.get_group("data")``: the ranks of its ``model`` coordinate), and a
leaf sharded over both axes is gathered over ``data`` only, to the rank's
``model`` piece (:mod:`repro_torch.distributed.tensor`).  The collectives
take card tensors over NCCL and over ``gloo`` alike (two ranks that share a
card run ``gloo``); a 2-byte float is gathered as its bytes.
Every collective is noted in :mod:`repro_torch.roofline.collectives`' log.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.distributed.sharding import Layout
from repro_torch.optim.optimizers import tree_map
from repro_torch.roofline import collectives

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ZeroScope:
    """The layouts of the parameter tree and the ``data`` group they shard over."""

    layouts: PyTree
    group: Any
    size: int


_SCOPE: Optional[ZeroScope] = None


@contextlib.contextmanager
def zero3(layouts: PyTree, group=None):
    """Gather ``data``-sharded leaves by ``layouts`` inside the block (the
    forward and the backward of one step)."""
    import torch.distributed as dist

    global _SCOPE
    prev = _SCOPE
    _SCOPE = ZeroScope(layouts, group, dist.get_world_size(group))
    try:
        yield _SCOPE
    finally:
        _SCOPE = prev


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _collective(new: str, old: str):
    """The torch.distributed function under its current name (torch 2.13
    renames ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` to the
    ``*_single`` names and warns on the old ones; older torch has only them)."""
    import torch.distributed as dist

    return getattr(dist, new, None) or getattr(dist, old)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 2-byte float as its bytes: a gather only moves bytes, and torch
    2.11's gloo refuses ``int16`` ("Invalid scalar type") where every
    version takes ``uint8``.  The rows along dim 0 keep their order."""
    return t.view(torch.uint8) if t.dtype in (torch.bfloat16, torch.float16) else t


def all_gather(shard: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` along ``dim``, in rank order."""
    shard = shard.contiguous()
    # the ranks' shards one after another along dim 0, as the collective wants
    buf = torch.empty((size * shard.shape[0],) + tuple(shard.shape[1:]), dtype=shard.dtype,
                      device=shard.device)
    _collective("all_gather_single", "all_gather_into_tensor")(_bits(buf), _bits(shard),
                                                               group=group)
    collectives.note("all-gather", buf.numel() * buf.element_size(), size)
    if dim == 0:
        return buf
    shape = list(shard.shape)
    shape[dim] *= size
    return buf.view((size,) + tuple(shard.shape)).movedim(0, dim).reshape(shape)


def reduce_scatter(full: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's shard along ``dim`` of the sum over the ranks of ``full``,
    summed in float32."""
    shape = list(full.shape)
    shape[dim: dim + 1] = [size, shape[dim] // size]
    parts = full.float().reshape(shape).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=torch.float32, device=full.device)
    parts = parts.view((size * out.shape[0],) + tuple(out.shape[1:]))
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, parts, group=group)
    collectives.note("reduce-scatter", out.numel() * out.element_size(), size)
    return out


def all_reduce(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """In-place sum over the ranks (of a dense copy where ``t`` is strided)."""
    import torch.distributed as dist

    t = t.contiguous()
    dist.all_reduce(t, group=group)
    collectives.note("all-reduce", t.numel() * t.element_size(), size)
    return t


class _Gather(torch.autograd.Function):
    """shard -> whole tensor; the gradient comes back reduce-scattered."""

    @staticmethod
    def forward(ctx, shard, dim, scope):
        ctx.dim, ctx.scope = dim, scope
        return all_gather(shard, dim, scope.group, scope.size)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.scope
        return reduce_scatter(grad, ctx.dim, s.group, s.size), None, None


# ---------------------------------------------------------------------------
# What the models call
# ---------------------------------------------------------------------------


def subtree(tree: PyTree, path: Tuple[str, ...]) -> PyTree:
    """The node of a nested dict at the key ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def gather(tree: PyTree, *path: str, stacked: bool = False) -> PyTree:
    """``tree`` (the parameters at ``path``; with ``stacked``, one layer of
    the stacked ``(L, ...)`` leaves at ``path``) with every ``data``-sharded
    leaf gathered whole.  The identity outside a :func:`zero3` scope."""
    scope = _SCOPE
    if scope is None:
        return tree

    def one(t, lay: Layout):
        dim = lay.data_dim
        return t if dim is None else _Gather.apply(t, dim - 1 if stacked else dim, scope)

    return tree_map(one, tree, subtree(scope.layouts, path))


# ---------------------------------------------------------------------------
# Whole trees, off the training step
# ---------------------------------------------------------------------------


def gathered_tree(tree: PyTree, layouts: PyTree, group=None) -> PyTree:
    """Every sharded leaf gathered whole over ``group`` (a collective: every
    rank calls it); replicated leaves as they are."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    return tree_map(lambda t, lay: t if lay.data_dim is None
                    else all_gather(t.detach(), lay.data_dim, group, size), tree, layouts)
