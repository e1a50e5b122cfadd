"""Explicit gradient allreduce schedules over ``torch.distributed`` (port of
:mod:`repro.distributed.allreduce`).

The paper's synchronization layer is Horovod's NCCL ring allreduce.  This
module holds the Horovod-faithful explicit ring and the reference's
variants, each over a process group (``None``: the default group) where the
reference names a mesh axis:

  * ``ring_allreduce``          -- reduce-scatter ring + all-gather ring,
                                   2(n-1) hops of 1/n chunks through
                                   ``dist.batch_isend_irecv``, in the
                                   reference's hop order and zero padding,
                                   so its float sums add in the JAX ring's
                                   order.
  * ``hierarchical_allreduce``  -- reduce-scatter over the intra group ->
                                   all-reduce over the inter group on 1/n
                                   shards -> all-gather over the intra group.
                                   The intra steps are the two halves of the
                                   ring above on every backend (one
                                   collective API: point-to-point sends and
                                   ``all_reduce``).
  * ``compressed_allreduce``    -- int8 with error feedback: the row
                                   quantizer (the CUDA kernel on a card
                                   tensor, its plain version on the CPU),
                                   then the sum of the dequantized values.

Every function works on one flat vector; the caller flattens the gradient
tree (:func:`flatten_grads`, buckets in :func:`bucketize`).  Every rank of
the group must call each function with a tensor of the same shape.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.train.steps import tree_leaves_sorted, tree_unflatten_sorted

PyTree = Any


def _peer(group, group_rank: int) -> int:
    """The default-group rank of ``group_rank`` in ``group``."""
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def _shift(send: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int, group) -> None:
    """Send ``send`` to ``nxt`` and receive ``recv`` from ``prv`` (one ring hop)."""
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                   dist.P2POp(dist.irecv, recv, prv, group)])
    for req in reqs:
        req.wait()


def _ring(x: torch.Tensor, group, between: Optional[Callable[[torch.Tensor], None]] = None
          ) -> torch.Tensor:
    """The reduce-scatter ring, ``between`` on the chunk this rank then owns
    (in place), and the all-gather ring; -> the gathered flat vector."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    size = x.shape[0]
    pad = (-size) % n
    chunks = F.pad(x, (0, pad)).reshape(n, -1).clone()     # chunk c lives at row c
    nxt, prv = _peer(group, (idx + 1) % n), _peer(group, (idx - 1) % n)
    recv = torch.empty_like(chunks[0])
    # reduce-scatter: at hop k rank d sends chunk (d - k) mod n and adds
    # what it receives into chunk (d - k - 1) mod n; after n - 1 hops it
    # owns the full sum of chunk (d + 1) mod n
    for k in range(n - 1):
        _shift(chunks[(idx - k) % n], recv, nxt, prv, group)
        chunks[(idx - k - 1) % n] += recv
    if between is not None:
        between(chunks[(idx + 1) % n])
    # all-gather ring: circulate the owned chunks
    for k in range(n - 1):
        _shift(chunks[(idx + 1 - k) % n], recv, nxt, prv, group)
        chunks[(idx - k) % n].copy_(recv)
    out = chunks.reshape(-1)
    return out[:size] if pad else out


def ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` over ``group``, moved in
    2(n-1) ring hops of 1/n-size chunks: each rank sends and receives
    2(n-1)/n of the payload, the bandwidth-optimal schedule of Horovod.
    One rank: ``x`` itself."""
    if dist.get_world_size(group) == 1:
        return x
    return _ring(x, group)


def hierarchical_allreduce(x: torch.Tensor, *, intra_group, inter_group) -> torch.Tensor:
    """reduce_scatter(intra) -> all_reduce(inter) on 1/n shards ->
    all_gather(intra): the slow link between hosts carries only
    ``bytes / n_intra`` a rank instead of the full ``bytes``."""
    return _ring(x, intra_group,
                 between=lambda shard: dist.all_reduce(shard, group=inter_group))


# ---------------------------------------------------------------------------
# Compressed (int8 + error feedback)
# ---------------------------------------------------------------------------


def payload_rows(y: torch.Tensor, noise: torch.Tensor, rows: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y`` and ``noise`` zero-padded to a multiple of ``rows`` and
    reshaped to ``(rows, -1)``: the quantizer's input in
    :func:`compressed_allreduce` (the reference's reshape)."""
    pad = (-y.shape[0]) % rows
    return (F.pad(y, (0, pad)).reshape(rows, -1),
            F.pad(noise, (0, pad)).reshape(rows, -1))


def compressed_allreduce(
    x: torch.Tensor,
    residual: torch.Tensor,
    noise: torch.Tensor,
    *,
    group=None,
    rows: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized allreduce with error feedback.

    ``y = x + residual`` is quantized to int8 by rows (stochastic rounding
    by ``noise``, uniform in [0, 1)), dequantized, and the dequantized f32
    values are summed over ``group`` (the reference's psum; on a wire the
    int8 payload would travel).  -> (the sum, the new residual
    ``y - dequant(q)``)."""
    y = x + residual
    size = y.shape[0]
    mat, noise_mat = payload_rows(y, noise, rows)
    q, scale = kops.quantize_int8(mat, noise_mat)
    deq = kops.dequantize_int8(q, scale).reshape(-1)[:size]
    new_residual = y - deq
    total = deq.contiguous()
    dist.all_reduce(total, group=group)
    return total, new_residual


# ---------------------------------------------------------------------------
# Bucketing (Horovod-style fusion buffers)
# ---------------------------------------------------------------------------


def flatten_grads(grads: PyTree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], PyTree]]:
    """Concatenate a gradient tree into one f32 vector (leaves in the
    reference's order, dict keys sorted) + its unflattener, which casts each
    leaf back to its dtype."""
    leaves = tree_leaves_sorted(grads)
    flat = torch.cat([leaf.float().reshape(-1) for leaf in leaves])

    def unflatten(vec: torch.Tensor) -> PyTree:
        out, off = [], 0
        for leaf in leaves:
            n = leaf.numel()
            out.append(vec[off:off + n].reshape(leaf.shape).to(leaf.dtype))
            off += n
        return tree_unflatten_sorted(grads, out)

    return flat, unflatten


def bucketize(flat: torch.Tensor, bucket_bytes: int = 64 * 1024 * 1024) -> List[torch.Tensor]:
    """Split a flat f32 vector into Horovod-style fusion buckets (views)."""
    per = max(1, bucket_bytes // 4)
    return [flat[i:i + per] for i in range(0, flat.shape[0], per)]


def make_ring_psum(mesh=None, axis: str = "data") -> Callable[[PyTree], PyTree]:
    """-> ``f(grads) -> summed tree`` through :func:`ring_allreduce` over the
    ``axis`` group of ``mesh`` (a ``DeviceMesh``; ``None``: the default
    group).  Every other mesh axis must hold replicated gradients."""
    group = None if mesh is None else mesh.get_group(axis)

    def allreduce(grads: PyTree) -> PyTree:
        flat, unflatten = flatten_grads(grads)
        return unflatten(ring_allreduce(flat, group))

    return allreduce
