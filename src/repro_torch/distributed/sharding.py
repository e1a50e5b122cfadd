"""Logical-axis -> mesh-axis sharding rules, resolved to ``DeviceMesh``
placements (port of :mod:`repro.distributed.sharding`).

Every parameter carries a tuple of *logical* axis names (assigned by the
model code via :mod:`repro_torch.models.param`).  A rule table maps logical
names to mesh axes; unlisted names are replicated.  A *spec* is a tuple with
one entry a tensor dim: a mesh axis name, a tuple of axis names, or ``None``
(trailing ``None``\\ s dropped, as ``PartitionSpec``'s).  On a mesh a spec
resolves to one DTensor placement a mesh dim: ``Shard(dim)`` where the mesh
dim's name appears at tensor dim ``dim``, else ``Replicate()``.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of a process group (the ``spmd`` cluster), or a :class:`ProcessMesh`: the
(data, model) grid of processes with one device each when no process group
binds them (one process, or a ``hostsync`` cluster).

The port trains data-parallel over the ``data`` axis: a leaf whose spec
names no mesh axis of more than one device is whole on every device, and a
leaf that names ``data`` (the configs' ``fsdp=True`` puts ``embed`` there)
is ZeRO-3 sharded, each rank holding the slice at its coordinate
(:meth:`Layout.local`), gathered a layer at a time inside the step
(:mod:`repro_torch.distributed.zero`).  :func:`check_plan` refuses what is
not ported: a leaf sharded over ``model`` (tensor and expert parallelism,
and with them the activation constraints ``with_logical_constraint``) and
a plan with several devices a process, :data:`SHARDED_WEIGHTS`, the second
half of ROADMAP item 19.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

PyTree = Any
MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

SHARDED_WEIGHTS = ("the second half of ROADMAP item 19 'Multi-device' (the model axis: "
                   "tensor and expert parallelism; several devices a process)")


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The (data, model) grid of a cluster's processes, one ``device`` each,
    held as its shape only: what a plan resolves against where no process
    group binds the processes (one process: 1 x 1; a ``hostsync`` cluster:
    ``data`` = its processes).  Mirrors the ``DeviceMesh`` attributes the
    rule functions read."""

    device: torch.device
    shape: Tuple[int, ...] = (1, 1)
    mesh_dim_names: Tuple[str, ...] = ("data", "model")

    @property
    def device_type(self) -> str:
        return torch.device(self.device).type


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`ProcessMesh`."""
    return {str(k): int(v) for k, v in zip(mesh.mesh_dim_names, tuple(mesh.shape))}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one tensor lives on a mesh: its spec and the DTensor placements
    it resolves to, one a mesh dim (``mesh_shape`` pairs each dim's name and
    size)."""

    spec: Spec
    placements: Tuple[Any, ...]
    mesh_shape: Tuple[Tuple[str, int], ...]

    @property
    def n_shards(self) -> int:
        """How many devices hold distinct pieces of the tensor."""
        return math.prod(size for (_, size), p in zip(self.mesh_shape, self.placements)
                         if p.is_shard())

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape of one device's piece of a tensor of ``shape``."""
        out = list(shape)
        for (_, size), p in zip(self.mesh_shape, self.placements):
            if p.is_shard():
                out[p.dim] //= size
        return tuple(out)

    @property
    def data_ways(self) -> int:
        """Size of the ``data`` mesh dim (1 without one)."""
        return dict(self.mesh_shape).get("data", 1)

    @property
    def data_dim(self) -> Optional[int]:
        """The tensor dim sharded over a ``data`` axis of two or more
        devices (ZeRO-3), or None where every rank holds that dim whole."""
        for (name, size), p in zip(self.mesh_shape, self.placements):
            if name == "data" and size > 1 and p.is_shard():
                return p.dim
        return None

    def local(self, full: torch.Tensor, coord: int) -> torch.Tensor:
        """The piece of the whole tensor ``full`` that the rank at ``coord``
        along ``data`` holds: its slice of :attr:`data_dim` (a view; the
        tensor itself where no dim is sharded)."""
        dim = self.data_dim
        if dim is None:
            return full
        n = full.shape[dim] // self.data_ways
        return full.narrow(dim, coord * n, n)

    def assemble(self, pieces) -> torch.Tensor:
        """Inverse of :meth:`local`: the whole tensor from the pieces of
        every coordinate along ``data``, in coordinate order."""
        pieces = list(pieces)
        dim = self.data_dim
        if dim is None:
            return pieces[0]
        if len(pieces) != self.data_ways:
            raise ValueError(f"{len(pieces)} pieces for a data axis of {self.data_ways}")
        return torch.cat(pieces, dim=dim)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """The resolved placement contract between data, params and the step.

    ``Session.shard()`` resolves the rule table against the live mesh once
    (:func:`repro_torch.train.steps.build_sharding_plan`): ``params`` and
    ``opt`` are trees of :class:`Layout` matching the param tree and the
    ``OptState`` (moments reuse the parameter layouts, the step counter is
    replicated), ``batch`` one layout a batch key (rows over the data
    axes), ``replicated`` the layout of metrics.  The meshfeed data plane
    lands this process's rows of every batch; the ``spmd`` step reduces
    gradients over the mesh's ``data`` group.  ``device`` is this process's
    torch device (one a process).  The plan is keyed by ``global_rows``: an
    elastic event that changes the row count re-derives it.
    """

    mesh: Any                 # DeviceMesh or ProcessMesh
    rules: Dict[str, Any]     # logical axis -> mesh axes, as resolved
    params: PyTree            # Layout tree matching the param tree
    opt: Any                  # OptState of Layouts (step replicated)
    batch: Dict[str, Any]     # Layout per batch key (tokens/labels/loss_mask)
    replicated: Any           # Layout of a replicated tensor (metrics)
    global_rows: int
    data_axis: int            # |mesh["data"]|: how many ways rows shard
    device: torch.device = torch.device("cpu")

    @property
    def n_devices(self) -> int:
        return math.prod(mesh_axis_sizes(self.mesh).values())

    def signature(self) -> Tuple[int, int, int]:
        return (self.global_rows, self.data_axis, self.n_devices)

    def describe(self) -> str:
        return (f"ShardingPlan(mesh={mesh_axis_sizes(self.mesh)}, "
                f"rows={self.global_rows}, data_axis={self.data_axis})")


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Baseline rules: tensor-parallel over "model", batch over ("pod","data").
# fsdp=True additionally shards the big weight matrices' embed axis over
# "data" (ZeRO-3 style).
def make_rules(
    *,
    fsdp: bool = False,
    seq_shard: bool = False,
    extra: Optional[Dict[str, MeshAxes]] = None,
) -> Dict[str, MeshAxes]:
    rules: Dict[str, MeshAxes] = {
        # -- weights --
        "layers": None,            # stacked-layer leading dim: never sharded
        "embed": "data" if fsdp else None,   # d_model rows of big matrices
        "vocab": "model",          # embedding/logit vocab dim
        "heads": "model",          # query heads
        "kv_heads": "model",       # kv heads
        "head_dim": None,
        "mlp": "model",            # ffn hidden
        "experts": "model",        # MoE expert dim (EP)
        "expert_mlp": None,        # per-expert ffn hidden
        "lru": "model",            # RG-LRU / RWKV channel blocks
        "conv": None,
        "pos": None,
        "norm": None,
        # -- activations --
        "batch": ("pod", "data"),
        "seq": "data" if seq_shard else None,  # SP for long-context decode
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "kv_seq": "data" if seq_shard else None,  # KV-cache seq dim (SP)
    }
    if extra:
        rules.update(extra)
    return rules


def spec_for(axes: Tuple[Optional[str], ...], rules: Dict[str, MeshAxes]) -> Spec:
    """Map a tuple of logical axis names to a spec; a mesh axis is used at
    most once (the first dim that names it takes it)."""
    parts = []
    used: set = set()

    def _usable(m: MeshAxes):
        if m is None:
            return None
        if isinstance(m, str):
            return None if m in used else m
        got = tuple(a for a in m if a not in used)
        return got if got else None

    for name in axes:
        mesh_axes = _usable(rules.get(name) if name is not None else None)
        if mesh_axes is None:
            parts.append(None)
        else:
            used.update((mesh_axes,) if isinstance(mesh_axes, str) else mesh_axes)
            parts.append(mesh_axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, str) or e is None for e in x)


def _map_axes(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if _is_axes(tree):
        return fn(tree)
    raise TypeError(f"not a logical-axes tree leaf: {tree!r}")


def specs_for_tree(axes_tree: PyTree, rules: Dict[str, MeshAxes]) -> PyTree:
    """Map a tree of logical-axis tuples to a tree of specs."""
    return _map_axes(lambda axes: spec_for(axes, rules), axes_tree)


def _divisible_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop mesh axes whose product does not divide the dim size, and axes
    the mesh does not have.  Argument placements must divide exactly, so
    e.g. a 56-head weight on a 16-way model axis falls back to replicated on
    that dim."""
    sizes = mesh_axis_sizes(mesh)
    parts = []
    for i, part in enumerate(spec):
        if part is None or i >= len(shape):
            parts.append(None)
            continue
        keep, prod = [], 1
        for a in ((part,) if isinstance(part, str) else tuple(part)):
            if a not in sizes:
                continue  # axis absent in this (smaller) mesh
            if shape[i] % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        parts.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(i)`` where the mesh dim's name stands at tensor dim ``i``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for i, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else tuple(part or ())):
            where[a] = i
    return tuple(Shard(where[name]) if name in where else Replicate()
                 for name in mesh_axis_sizes(mesh))


def layout_for(spec: Spec, mesh) -> Layout:
    return Layout(spec=spec, placements=placements_for(spec, mesh),
                  mesh_shape=tuple(mesh_axis_sizes(mesh).items()))


def _zip_leaves(axes_tree: PyTree, shapes_tree: PyTree, fn) -> PyTree:
    if isinstance(axes_tree, dict):
        if set(axes_tree) != set(shapes_tree):
            raise ValueError(f"axes and shapes trees differ: {sorted(axes_tree)} vs "
                             f"{sorted(shapes_tree)}")
        return {k: _zip_leaves(v, shapes_tree[k], fn) for k, v in axes_tree.items()}
    return fn(axes_tree, shapes_tree)


def arg_shardings_for_tree(
    axes_tree: PyTree, shapes_tree: PyTree, rules: Dict[str, MeshAxes], mesh
) -> PyTree:
    """Layouts for step arguments, size-aware (divisibility-safe).
    ``shapes_tree`` carries the leaf shapes (tensors, meta tensors included,
    in the same structure as ``axes_tree``)."""
    return _zip_leaves(axes_tree, shapes_tree, lambda axes, leaf: layout_for(
        _divisible_spec(spec_for(axes, rules), tuple(leaf.shape), mesh), mesh))


def iter_layouts(tree: PyTree, prefix: str = "") -> Iterator[Tuple[str, Layout]]:
    """(path, layout) of every leaf of a layout tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_layouts(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, Layout):
        yield prefix, tree


def is_zero3(plan: ShardingPlan) -> bool:
    """Whether ``plan`` shards any parameter leaf over ``data`` (ZeRO-3)."""
    return any(lay.data_dim is not None for _, lay in iter_layouts(plan.params))


def check_plan(plan: ShardingPlan, processes: Optional[int] = None) -> ShardingPlan:
    """Raise ``NotImplementedError`` where ``plan`` needs what the port does
    not run (:data:`SHARDED_WEIGHTS`): a parameter or optimizer leaf sharded
    over a mesh axis other than ``data`` of two or more devices (tensor or
    expert parallelism), or more devices than ``processes``.  Leaves whole
    on every device and leaves sharded over ``data`` (ZeRO-3) pass; return
    the plan."""
    if processes is not None and plan.n_devices > processes:
        raise NotImplementedError(
            f"the plan spans {plan.n_devices} devices over {processes} process(es): a "
            f"process drives one device; several devices a process is {SHARDED_WEIGHTS}")
    trees = [("params", plan.params), ("opt.mu", plan.opt.mu), ("opt.nu", plan.opt.nu)]
    for name, tree in trees:
        for path, lay in iter_layouts(tree):
            for (axis, size), p in zip(lay.mesh_shape, lay.placements):
                if axis != "data" and size > 1 and p.is_shard():
                    raise NotImplementedError(
                        f"the plan shards {name} leaf {path!r} over {axis!r} on {size} devices "
                        f"(spec {lay.spec} on mesh {dict(lay.mesh_shape)}): {SHARDED_WEIGHTS}")
    return plan


# ---------------------------------------------------------------------------
# The rule table in force
# ---------------------------------------------------------------------------

# (the reference's ``constrain`` switch and ``with_logical_constraint``, the
# table's reader inside the model, come with tensor parallelism)
_CURRENT_RULES: Dict[str, MeshAxes] = make_rules()


def set_rules(rules: Dict[str, MeshAxes]) -> None:
    global _CURRENT_RULES
    _CURRENT_RULES = rules


def get_rules() -> Dict[str, MeshAxes]:
    return _CURRENT_RULES


@contextlib.contextmanager
def use_rules(rules: Dict[str, MeshAxes]):
    """Temporarily install a rule table (and restore the previous one)."""
    global _CURRENT_RULES
    prev = _CURRENT_RULES
    _CURRENT_RULES = rules
    try:
        yield
    finally:
        _CURRENT_RULES = prev
