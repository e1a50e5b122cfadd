"""Train / eval / serve step factories (port of :mod:`repro.train.steps`).

``make_train_step`` builds the masked-weighted-loss training step
(:mod:`repro_torch.core.hetero` semantics): per-token CE, multiplied by the
combined row-validity x token mask, summed and normalized GLOBALLY, so
heterogeneous group batch sizes are numerically exact.  ``make_serve_step``
builds the one-token KV-cache decode step.

Cluster (``hostsync``) training splits the step in two halves:
``make_partial_grad_step`` (this process's unnormalized gradient over its
row slab) and ``make_apply_step`` (the identical update every replica
applies to the across-process sums); the bucketed forms carry the gradient
as flat f32 vectors, the cluster transport's wire format, laid out in the
reference's leaf order (:func:`tree_leaves_sorted`: dict keys sorted at
every level, as ``jax.tree_util.tree_leaves``).

``spmd`` cluster training (one replica a rank of a ``torch.distributed``
group) runs the same two halves in one step, :func:`make_spmd_train_step`:
the partial gradient, ``dist.all_reduce`` of the gradient leaves and of
the loss's numerator and denominator, then the identical update on every
replica.  Under a plan that shards weights over ``data`` (ZeRO-3,
:mod:`repro_torch.distributed.zero`) a rank holds and updates only its
shards; their gradients arrive reduce-scattered from the gathers'
backward.  :func:`build_sharding_plan` resolves the rule table
(:mod:`repro_torch.distributed.sharding`) against a mesh, as the
reference's does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.hetero import masked_mean_loss
from repro_torch.distributed import tensor, zero
from repro_torch.distributed.sharding import (
    ShardingPlan, arg_shardings_for_tree, layout_for, make_rules, mesh_axis_sizes, use_mesh,
    use_rules,
)
from repro_torch.models.param import keeping
from repro_torch.roofline import collectives
from repro_torch.models.api import Model
from repro_torch.optim.optimizers import Optimizer, OptState, tree_leaves, tree_map

PyTree = Any

# logical axes of the Stannis batch (the reference's ``BATCH_AXES``)
BATCH_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", "seq_data"),
    "labels": ("batch", "seq_data"),
    "loss_mask": ("batch", "seq_data"),
}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Per-token CE, numerically stable. logits (B,S,V) f32/bf16; labels (B,S).
    Logits narrower than ``vocab`` are a tensor-parallel rank's vocabulary
    columns: the loss is then the vocabulary-parallel one over the mesh in
    scope (:func:`repro_torch.distributed.tensor.cross_entropy`)."""
    if vocab is not None and logits.shape[-1] != vocab:
        axis = tensor.model_axis()
        if axis is None or logits.shape[-1] * axis.size != vocab:
            raise ValueError(f"logits of {logits.shape[-1]} columns for a vocabulary of "
                             f"{vocab} outside a model axis that splits it")
        return tensor.cross_entropy(logits, labels, axis)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def loss_fn(
    model: Model,
    params: PyTree,
    batch: Dict[str, torch.Tensor],
    *,
    aux_weight: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked global-mean LM loss (+ router aux for MoE).  A batch's
    ``frames`` (encdec) or ``patch_embeds`` (vlm) go to the forward; where
    the logits are longer than the labels (the VLM's [patches | text]) only
    the last ``labels.shape[1]`` positions, the text, are scored."""
    side = {k: batch[k] for k in ("frames", "patch_embeds") if k in batch}
    logits, aux = model.forward(params, batch["tokens"], **side)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    ce = cross_entropy(logits, labels, model.cfg.vocab)
    mask = batch["loss_mask"]
    loss = masked_mean_loss(ce, mask)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": torch.sum(mask)}


def value_and_grad(
    model: Model, params: PyTree, batch: Dict[str, torch.Tensor], *, aux_weight: float = 0.01,
) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]], PyTree]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((total, parts), grads),
    grads a tree shaped like ``params``.  ``params`` are not modified."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, parts = loss_fn(model, live, batch, aux_weight=aux_weight)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    return (total.detach(), {k: v.detach() for k, v in parts.items()}), \
        tree_map(lambda _: next(it), live)


def make_train_step(
    model: Model,
    optimizer: Optimizer,
    lr_schedule: Callable[[int], torch.Tensor],
    *,
    aux_weight: float = 0.01,
    grad_transform: Optional[Callable[[PyTree], PyTree]] = None,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    The optimizer updates ``params`` and the moments in place (the JAX
    package donates them) and the step returns the same tensors.  Metrics
    are 0-d tensors: loss, aux, total, lr, grad_norm (the square root of the
    float32 sum of squares of every gradient) and tokens.
    """

    def train_step(params, opt_state: OptState, batch):
        (total, parts), grads = value_and_grad(model, params, batch, aux_weight=aux_weight)
        if grad_transform is not None:
            grads = grad_transform(grads)
        lr = lr_schedule(opt_state.step)
        opt_state, params = optimizer.update(grads, opt_state, params, lr)
        # elementwise square + sum per leaf, as the reference (not a vdot)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        metrics = {
            "loss": parts["loss"],
            "aux": parts["aux"],
            "total": total,
            "lr": lr,
            "grad_norm": gnorm,
            "tokens": parts["tokens"],
        }
        return params, opt_state, metrics

    return train_step


def residual_bytes(
    model: Model, params: PyTree, batch: Dict[str, torch.Tensor], *, aux_weight: float = 0.01,
) -> int:
    """Bytes of the tensors autograd saves for the backward of one loss.

    Counted through ``torch.autograd.graph.saved_tensors_hooks`` over a real
    forward on ``batch`` (the reference prices the same set by
    ``eval_shape`` of the vjp pullback): the footprint that
    ``train_precision="int8-fused"`` shrinks by saving K/V as int8 + per-row
    scales.  A tensor saved twice counts twice.
    """
    total = 0

    def pack(t: torch.Tensor) -> torch.Tensor:
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss_fn(model, live, batch, aux_weight=aux_weight)
    return total


# ---------------------------------------------------------------------------
# Cluster (hostsync) halves
# ---------------------------------------------------------------------------


def _sorted_paths(tree: PyTree, prefix: Tuple = ()) -> List[Tuple]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _sorted_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _sorted_paths(v, prefix + (i,))]
    return [prefix]


def _at(tree: PyTree, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves_sorted(tree: PyTree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted at
    every level (the port's :func:`tree_leaves` walks insertion order)."""
    return [_at(tree, p) for p in _sorted_paths(tree)]


def tree_unflatten_sorted(like: PyTree, leaves: List[Any]) -> PyTree:
    """Inverse of :func:`tree_leaves_sorted` onto the structure of ``like``."""
    by_path = dict(zip(_sorted_paths(like), leaves))

    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        return by_path[prefix]

    return build(like, ())


def make_partial_grad_step(model: Model, *, aux_weight: float = 0.01) -> Callable:
    """The per-host half of cluster (hostsync) training.

    Returns ``grad_step(params, batch) -> (grads, sums)`` computing this
    host's UNNORMALIZED contribution to the global objective over its local
    rows only:

        F_p(params) = Σ_p mask·ce  +  aux_weight · den_p · aux_p
        sums        = {num: Σ mask·ce, den: Σ mask, auxden: den_p · aux_p}

    The global masked-mean step is ``total = (Σ_p F_p) / max(Σ_p den_p, 1)``
    — a ratio of ACROSS-host sums — so summing each host's ``grads`` and
    ``sums`` and applying :func:`make_apply_step` reproduces
    :func:`make_train_step` (dense models; an MoE router aux becomes its
    den-weighted mean, which coincides for P=1).  ``params`` are not
    modified.
    """

    def objective(params, batch):
        side = {k: batch[k] for k in ("frames", "patch_embeds") if k in batch}
        logits, aux = model.forward(params, batch["tokens"], **side)
        labels = batch["labels"]
        mask = batch["loss_mask"]
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        ce = cross_entropy(logits, labels, model.cfg.vocab)
        num = torch.sum(ce * mask)
        den = torch.sum(mask)
        auxden = den * aux
        return num + aux_weight * auxden, {"num": num, "den": den, "auxden": auxden}

    def grad_step(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, sums = objective(live, batch)
        grads = torch.autograd.grad(total, tree_leaves(live))
        it = iter(grads)
        return tree_map(lambda _: next(it), live), {k: v.detach() for k, v in sums.items()}

    return grad_step


def make_apply_step(
    optimizer: Optimizer,
    lr_schedule: Callable[[int], torch.Tensor],
    *,
    aux_weight: float = 0.01,
    grad_sq: Optional[Callable[[PyTree], torch.Tensor]] = None,
) -> Callable:
    """The update half of cluster (hostsync) training.

    ``apply_step(params, opt_state, grads, sums) -> (params, opt_state,
    metrics)`` consumes the ACROSS-host sums of :func:`make_partial_grad_step`
    outputs (0-d float32 tensors on the params' device).  Every host applies
    the identical update to its identical params — replicas stay
    bit-synchronized without a broadcast — in place, as
    :func:`make_train_step`, whose metrics it reports.  A gradient is divided
    in float32 whatever its dtype, as the reference's bf16 / f32 promotes.
    ``grad_sq(grads)`` is the squared gradient norm (default: this tree's
    own sum of squares; a ZeRO-3 rank's counts every shard once).
    """

    def apply_step(params, opt_state: OptState, grads, sums):
        den = torch.clamp(sums["den"], min=1.0)
        loss = sums["num"] / den
        aux = sums["auxden"] / den
        grads = tree_map(lambda g: g.float() / den, grads)
        lr = lr_schedule(opt_state.step)
        opt_state, params = optimizer.update(grads, opt_state, params, lr)
        gnorm = torch.sqrt(grad_sq(grads) if grad_sq is not None else
                           sum(torch.sum(torch.square(g)) for g in tree_leaves(grads)))
        metrics = {
            "loss": loss,
            "aux": aux,
            "total": loss + aux_weight * aux,
            "lr": lr,
            "grad_norm": gnorm,
            "tokens": sums["den"],
        }
        return params, opt_state, metrics

    return apply_step


def plan_buckets(params_abs: PyTree, n_buckets: int) -> Tuple[Tuple[int, ...], ...]:
    """Split the param-leaf list into contiguous, byte-balanced groups.

    Buckets are the cluster transport's unit of pipelining: the hostsync
    grad step emits one flat f32 vector per group, so bucket *i*'s
    reduction overlaps bucket *i+1*'s encode.  Greedy contiguous packing
    over :func:`tree_leaves_sorted` (the reference's leaf order, which every
    worker shares); leaves may be tensors of any device, meta included.
    """
    leaves = tree_leaves_sorted(params_abs)
    n_leaves = len(leaves)
    n_buckets = max(1, min(int(n_buckets), n_leaves))
    sizes = [leaf.element_size() * leaf.numel() for leaf in leaves]
    groups = []
    start = 0
    left_bytes = float(sum(sizes))
    for b in range(n_buckets):
        buckets_left = n_buckets - b
        if buckets_left == 1:
            groups.append(tuple(range(start, n_leaves)))
            break
        target = left_bytes / buckets_left
        take, acc = 1, sizes[start]
        while (
            start + take < n_leaves
            and (n_leaves - start - take) > (buckets_left - 1)
            and abs(acc + sizes[start + take] - target) <= abs(acc - target)
        ):
            acc += sizes[start + take]
            take += 1
        groups.append(tuple(range(start, start + take)))
        start += take
        left_bytes -= acc
    return tuple(groups)


def flatten_buckets(tree: PyTree, bucket_groups: Tuple[Tuple[int, ...], ...]
                    ) -> Tuple[torch.Tensor, ...]:
    """One flat float32 vector per bucket group, leaves in sorted order."""
    leaves = tree_leaves_sorted(tree)
    return tuple(
        leaves[grp[0]].float().reshape(-1) if len(grp) == 1 else
        torch.cat([leaves[i].float().reshape(-1) for i in grp])
        for grp in bucket_groups
    )


def unflatten_buckets(like: PyTree, bucket_groups: Tuple[Tuple[int, ...], ...],
                      bucket_vecs, device: Optional[torch.device] = None) -> PyTree:
    """Exact inverse of :func:`flatten_buckets` onto ``like``'s shapes and
    dtypes (a float32 round trip of f32/bf16 leaves is lossless), each leaf
    on ``device`` (default: where its vector lies).  Vectors on the host land
    leaf by leaf, so no device copy of a whole bucket is ever held."""
    leaves_like = tree_leaves_sorted(like)
    leaves: List[Any] = [None] * len(leaves_like)
    for grp, vec in zip(bucket_groups, bucket_vecs):
        off = 0
        for i in grp:
            n = leaves_like[i].numel()
            leaves[i] = vec[off:off + n].reshape(leaves_like[i].shape).to(
                device=device or vec.device, dtype=leaves_like[i].dtype)
            off += n
    return tree_unflatten_sorted(like, leaves)


def make_bucketed_grad_step(
    model: Model,
    bucket_groups: Tuple[Tuple[int, ...], ...],
    *,
    aux_weight: float = 0.01,
) -> Callable:
    """:func:`make_partial_grad_step` with the grad tree flattened into one
    f32 vector per bucket group — the cluster transport's wire format.
    Returns ``grad_step(params, batch) -> (bucket_vecs, sums)``.
    """
    base = make_partial_grad_step(model, aux_weight=aux_weight)

    def grad_step(params, batch):
        grads, sums = base(params, batch)
        return flatten_buckets(grads, bucket_groups), sums

    return grad_step


def make_bucketed_apply_step(
    optimizer: Optimizer,
    lr_schedule: Callable[[int], torch.Tensor],
    params_abs: PyTree,
    bucket_groups: Tuple[Tuple[int, ...], ...],
    *,
    aux_weight: float = 0.01,
) -> Callable:
    """:func:`make_apply_step` taking the reduced bucket vectors (float32,
    on the params' device or on the host) instead of a grad tree; the
    unflatten is :func:`unflatten_buckets` onto the params' device, so
    bucketing never changes numerics.
    """
    base = make_apply_step(optimizer, lr_schedule, aux_weight=aux_weight)

    def apply_step(params, opt_state: OptState, bucket_vecs, sums):
        device = tree_leaves(params)[0].device
        grads = unflatten_buckets(params_abs, bucket_groups, bucket_vecs, device)
        return base(params, opt_state, grads, sums)

    return apply_step


def allreduce_tree(tree: PyTree, group=None) -> PyTree:
    """``dist.all_reduce`` (sum) over ``group`` of each leaf of ``tree``, in
    the reference's leaf order, in place where a leaf is dense; a strided
    leaf (a kernel's backward on the card hands one back) is reduced as a
    dense copy, since NCCL takes dense tensors only.  -> the summed tree."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    return tree_unflatten_sorted(tree, [zero.all_reduce(x, group, size)
                                        for x in tree_leaves_sorted(tree)])


def _zero3_reduce(grads: PyTree, lays: List[Any], group) -> PyTree:
    """A rank's gradients after the step's reduction over its ``data``
    group: the ``data``-sharded leaves' arrived summed from the gathers'
    backward; the others (replicated over ``data``) are all-reduced here.
    ``lays``: the layouts in the reference's leaf order."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    out = [g if lay.data_dim is not None else zero.all_reduce(g, group, size)
           for g, lay in zip(tree_leaves_sorted(grads), lays)]
    return tree_unflatten_sorted(grads, out)


def _zero3_grad_sq(lays: List[Any], group) -> Callable[[PyTree], torch.Tensor]:
    """The squared gradient norm of a ZeRO-3 rank's reduced gradients: the
    shards' sum of squares all-reduced, plus the replicated leaves' (whole
    on every rank) counted once."""
    import torch.distributed as dist

    size = dist.get_world_size(group)

    def grad_sq(grads: PyTree) -> torch.Tensor:
        sq = [torch.sum(torch.square(g.float())) for g in tree_leaves_sorted(grads)]
        sharded = torch.stack([x for x, lay in zip(sq, lays) if lay.data_dim is not None])
        total = zero.all_reduce(torch.sum(sharded), group, size)
        return total + sum(x for x, lay in zip(sq, lays) if lay.data_dim is None)

    return grad_sq


def _mesh_grad_sq(lays: List[Any], data_group, model_group) -> Callable[[PyTree], torch.Tensor]:
    """The squared gradient norm on a (data, model) mesh: each leaf's sum of
    squares all-reduced over the axes that shard it (``data`` first), so a
    ``model``-sharded leaf's squares count once over ``model`` and a
    replicated leaf's once."""
    import torch.distributed as dist

    d_size = 1 if data_group is None else dist.get_world_size(data_group)
    m_size = dist.get_world_size(model_group)

    def over(x: torch.Tensor, axes: Tuple[bool, bool]) -> torch.Tensor:
        if axes[0] and d_size > 1:
            x = zero.all_reduce(x, data_group, d_size)
        if axes[1]:
            x = zero.all_reduce(x, model_group, m_size)
        return x

    def grad_sq(grads: PyTree) -> torch.Tensor:
        parts: Dict[Tuple[bool, bool], List[torch.Tensor]] = {}
        for g, lay in zip(tree_leaves_sorted(grads), lays):
            key = (lay.data_dim is not None, lay.model_dim is not None)
            parts.setdefault(key, []).append(torch.sum(torch.square(g.float())))
        return sum(over(torch.sum(torch.stack(xs)), key) for key, xs in sorted(parts.items()))

    return grad_sq


def mesh_rank(mesh) -> int:
    """This rank's flat index on ``mesh`` (row-major over its dims), what
    :meth:`~repro_torch.distributed.sharding.Layout.local` takes."""
    coord = mesh.get_coordinate()
    rank = 0
    for c, size in zip(coord, mesh_axis_sizes(mesh).values()):
        rank = rank * size + int(c)
    return rank


def init_rank_params(model: Model, plan: ShardingPlan, rank: int, *, seed: int,
                     device) -> PyTree:
    """The pieces the device at flat ``rank`` holds of the weights drawn
    from ``seed``: each leaf drawn whole on ``device``, its piece kept and
    the rest freed, one leaf at a time, so the pieces are bit for bit the
    slices of the whole init on both mesh axes."""
    def keep(path, leaf):
        lay = zero.subtree(plan.params, path)
        return leaf if lay.n_shards == 1 else lay.local(leaf, rank).clone()

    with keeping(keep):
        params, _ = model.init_params(seed=seed, device=device)
    return params


def make_spmd_train_step(
    model: Model,
    optimizer: Optimizer,
    lr_schedule: Callable[[int], torch.Tensor],
    *,
    timing: Dict[str, float],
    group=None,
    aux_weight: float = 0.01,
    layouts: Optional[PyTree] = None,
    collective_log: Optional[List[collectives.Op]] = None,
    plan: Optional[ShardingPlan] = None,
) -> Callable:
    """The ``spmd`` cluster step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` over this rank's rows.

    :func:`make_partial_grad_step` on the rank's rows, then
    ``dist.all_reduce`` over ``group`` (``None``: the default group) of
    each gradient leaf (:func:`allreduce_tree`; the leaves are stacked a
    layer kind, so the calls are few) and of the sums
    ``num, den, auxden`` in one float32 vector, then :func:`make_apply_step`
    on the totals, identically on every replica.  The masked loss is the
    ratio of the across-rank sums, never a mean of rank means, so the update
    is the single-program step's.

    ``layouts`` (the plan's parameter layouts) that shard a leaf over
    ``data`` make it ZeRO-3: ``params`` and the moments are this rank's
    shards, the forward and backward run inside
    :func:`~repro_torch.distributed.zero.zero3` (a layer's weights gathered
    where it runs, their gradients reduce-scattered), only the replicated
    leaves are all-reduced, and the update touches the local shards.

    ``plan`` (a :class:`ShardingPlan` on a ``DeviceMesh`` of the ranks, the
    reference's ``set_mesh`` + ``jit(make_train_step)``) gives the layouts,
    the rule table and the mesh: on a ``model`` axis of two or more ranks
    the forward is tensor- and expert-parallel
    (:mod:`repro_torch.distributed.tensor`), ``params`` hold the rank's
    pieces on both axes (:func:`init_rank_params`), the gradients and loss
    sums are reduced over the rank's ``data`` group only (every ``model``
    piece's gradient arrives whole from the forward's collectives), and the
    gradient norm counts each piece once.

    ``timing`` accumulates the seconds of ``grad_s`` (to the gradient's end
    on the device, ZeRO-3's gathers and reduce-scatters and the tensor-
    parallel collectives included), ``reduce_s`` (the all-reduces) and
    ``apply_s`` and counts ``steps``; ``collective_log``, where given,
    holds the last step's collectives
    (:mod:`repro_torch.roofline.collectives`).
    """
    import contextlib
    import time

    import torch.distributed as dist

    mesh = None
    if plan is not None:
        mesh, layouts = plan.mesh, plan.params
        sizes = mesh_axis_sizes(mesh)
        group = mesh.get_group("data") if sizes.get("data", 1) > 1 else None
        model_group = mesh.get_group("model") if sizes.get("model", 1) > 1 else None
    lays = [] if layouts is None else tree_leaves_sorted(layouts)
    sharded = any(lay.data_dim is not None for lay in lays)
    if mesh is not None and model_group is not None:
        grad_sq = _mesh_grad_sq(lays, group, model_group)
    else:
        grad_sq = _zero3_grad_sq(lays, group) if sharded else None
    grad_step = make_partial_grad_step(model, aux_weight=aux_weight)
    apply_step = make_apply_step(optimizer, lr_schedule, aux_weight=aux_weight,
                                 grad_sq=grad_sq)
    keys = ("num", "den", "auxden")
    # a mesh's data group of one rank reduces nothing
    reduce_data = mesh is None or group is not None

    def sync(device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def scope():
        stack = contextlib.ExitStack()
        if mesh is not None:
            stack.enter_context(use_rules(plan.rules))
            stack.enter_context(use_mesh(mesh))
        if sharded:
            stack.enter_context(zero.zero3(layouts, group))
        return stack

    def train_step(params, opt_state: OptState, batch):
        device = tree_leaves(params)[0].device
        log: List[collectives.Op] = []
        t0 = time.perf_counter()
        with collectives.recording(log):
            with scope():
                grads, sums = grad_step(params, batch)
            t1 = sync(device)
            if mesh is not None:
                grads = _zero3_reduce(grads, lays, group) if reduce_data else grads
            else:
                grads = (_zero3_reduce(grads, lays, group) if sharded
                         else allreduce_tree(grads, group))
            totals = torch.stack([sums[k].float() for k in keys])
            if reduce_data:
                totals = zero.all_reduce(totals, group, dist.get_world_size(group))
            t2 = sync(device)
            out = apply_step(params, opt_state, grads,
                             {k: totals[i] for i, k in enumerate(keys)})
            t3 = sync(device)
        if collective_log is not None:
            collective_log[:] = log
        for key, dt in (("grad_s", t1 - t0), ("reduce_s", t2 - t1), ("apply_s", t3 - t2),
                        ("steps", 1)):
            timing[key] = timing.get(key, 0.0) + dt
        return out

    return train_step


# ---------------------------------------------------------------------------
# The sharding plan
# ---------------------------------------------------------------------------


def abstract_batch(global_rows: int, seq_len: int) -> Dict[str, torch.Tensor]:
    """The Stannis batch as meta tensors (keys match ``BATCH_AXES``)."""
    return {
        "tokens": torch.empty((global_rows, seq_len), dtype=torch.int32, device="meta"),
        "labels": torch.empty((global_rows, seq_len), dtype=torch.int32, device="meta"),
        "loss_mask": torch.empty((global_rows, seq_len), dtype=torch.float32, device="meta"),
    }


def build_sharding_plan(
    model: Model,
    optimizer: Optimizer,
    *,
    mesh,
    global_rows: int,
    seq_len: int,
    extra_rules: Optional[Dict[str, Any]] = None,
    device: Optional[torch.device] = None,
) -> ShardingPlan:
    """Resolve the rule table against ``mesh`` into one ShardingPlan.

    Size-aware (:func:`~repro_torch.distributed.sharding.arg_shardings_for_tree`):
    a dim a mesh axis does not divide falls back to replicated on that dim.
    Optimizer moments reuse the parameter layouts (same shapes, f32), the
    step counter and metrics are replicated, and batch rows shard over the
    data axes.  ``device`` is this process's device (default: the mesh's)."""
    rules = make_rules(fsdp=bool(getattr(model.cfg, "fsdp", False)), extra=extra_rules or None)
    rules.setdefault("seq_data", None)
    replicated = layout_for((), mesh)
    params_abs, p_axes = model.init_params(abstract=True)
    p_sh = arg_shardings_for_tree(p_axes, params_abs, rules, mesh)
    opt_abs = optimizer.init(params_abs)
    opt_sh = OptState(step=replicated, mu=p_sh, nu=None if opt_abs.nu is None else p_sh)
    b_sh = arg_shardings_for_tree(BATCH_AXES, abstract_batch(global_rows, seq_len), rules, mesh)
    if device is None:
        device = torch.device(getattr(mesh, "device", None) or mesh.device_type)
    return ShardingPlan(
        mesh=mesh, rules=rules, params=p_sh, opt=opt_sh, batch=b_sh, replicated=replicated,
        global_rows=int(global_rows),
        data_axis=mesh_axis_sizes(mesh).get("data", 1),
        device=torch.device(device), family=model.cfg.family, axes=p_axes,
        **lru_split(model.cfg),
    )


def lru_split(cfg) -> Dict[str, int]:
    """The ``lru`` axis's whole width and the channels a ``model`` split
    keeps together: an RWKV-6 head's (its group norm and bonus ``u`` are
    per head), else one (every RG-LRU gate is diagonal)."""
    return {"lru_width": tensor.lru_width(cfg),
            "lru_group": cfg.rwkv_head_dim if cfg.family == "rwkv6" else 1}


def make_eval_step(model: Model, *, aux_weight: float = 0.01) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, parts = loss_fn(model, params, batch, aux_weight=aux_weight)
        return parts

    return eval_step


def make_serve_step(model: Model) -> Callable:
    """One-token decode: (params, token, cache, pos) -> (next_token, logits, cache).

    The cache is updated in place and returned.  Under the mesh in scope
    (:func:`~repro_torch.distributed.sharding.use_mesh`, the reference's
    ``set_mesh`` + ``jit(make_serve_step)`` with the cache sharded by
    ``cache_logical_axes``) the step is tensor-parallel: ``params`` and
    ``cache`` are the rank's pieces, the logits whole."""

    def serve_step(params, token, cache, pos):
        logits, cache = model.decode_step(params, token, cache, pos)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], logits, cache

    return serve_step


def make_prefill_step(model: Model, cache_len: int) -> Callable:
    """(params, tokens) -> (last logits, cache) of ``Model.prefill``,
    tensor-parallel under the mesh in scope as :func:`make_serve_step`."""
    def prefill_step(params, tokens):
        return model.prefill(params, tokens, cache_len)

    return prefill_step
