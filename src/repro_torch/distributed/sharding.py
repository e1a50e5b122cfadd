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

The port trains over both axes.  A leaf whose spec names no mesh axis of
more than one device is whole on every device.  A leaf that names ``data``
(the configs' ``fsdp=True`` puts ``embed`` there) is ZeRO-3 sharded, each
rank holding the slice at its coordinate (:meth:`Layout.local`), gathered
a layer at a time inside the step (:mod:`repro_torch.distributed.zero`).
A leaf that names ``model`` (heads, FFN columns, vocabulary rows, experts)
is the rank's piece of a tensor- or expert-parallel product
(:mod:`repro_torch.distributed.tensor`), in every family: the dense and MoE
decoders, RWKV-6 and RecurrentGemma (their ``lru`` channel blocks), the
encoder-decoder and the vision-language backbone.  The models read the mesh
in scope (:func:`use_mesh`, the counterpart of the reference's
``set_mesh``) and check their activations' layout with
:func:`with_logical_constraint`.  Serving runs under the same mesh: a
cache leaf of logical axes (``Model.cache_logical_axes``) is allocated at
the rank's piece (:func:`local_shape`).  Query heads the ``model`` axis does
not divide stay whole on every rank, which computes its block of them (the
reference's padded split).  :func:`check_plan` refuses what is not ported,
:data:`SHARDED_WEIGHTS`: an ``lru`` split that cuts an RWKV head, and
several devices a process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

PyTree = Any
MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

SHARDED_WEIGHTS = ("the rest of the second half of ROADMAP item 19 'Multi-device' (an lru "
                   "split that cuts an RWKV head; batch rows over model outside the MoE "
                   "layer; query heads that the rules keep whole while the model axis splits "
                   "other leaves; several devices a process)")

# the families whose forward runs tensor and expert parallelism over ``model``
TP_FAMILIES = ("dense", "moe", "rwkv6", "rglru", "encdec", "vlm")
# the logical axes a tensor-parallel forward reads a ``model`` shard of
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "experts", "lru")


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

    def whole_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Inverse of :meth:`shard_shape`: the whole tensor's shape from one
        device's piece of ``shape``."""
        out = list(shape)
        for (_, size), p in zip(self.mesh_shape, self.placements):
            if p.is_shard():
                out[p.dim] *= size
        return tuple(out)

    @property
    def data_ways(self) -> int:
        """Size of the ``data`` mesh dim (1 without one)."""
        return dict(self.mesh_shape).get("data", 1)

    def dim_over(self, axis: str) -> Optional[int]:
        """The tensor dim sharded over the mesh dim ``axis`` of two or more
        devices, or None where every rank along it holds the tensor whole."""
        for (name, size), p in zip(self.mesh_shape, self.placements):
            if name == axis and size > 1 and p.is_shard():
                return p.dim
        return None

    @property
    def data_dim(self) -> Optional[int]:
        """The tensor dim sharded over a ``data`` axis of two or more
        devices (ZeRO-3), or None where every rank holds that dim whole."""
        return self.dim_over("data")

    @property
    def model_dim(self) -> Optional[int]:
        """The tensor dim sharded over a ``model`` axis of two or more
        devices (tensor or expert parallelism), or None."""
        return self.dim_over("model")

    def coords(self, rank: int) -> Tuple[int, ...]:
        """The mesh coordinates of the device at flat ``rank`` (row-major
        over the mesh dims: on a ``data x 1`` mesh, the ``data`` coordinate)."""
        out = []
        for _, size in reversed(self.mesh_shape):
            out.append(rank % size)
            rank //= size
        return tuple(reversed(out))

    def _cuts(self, rank: int):
        """(tensor dim, ways, index) of each mesh dim that shards the tensor,
        in mesh-dim order (two mesh dims on one tensor dim nest, the first
        outermost)."""
        return [(p.dim, size, c) for (_, size), p, c in
                zip(self.mesh_shape, self.placements, self.coords(rank))
                if p.is_shard() and size > 1]

    def index(self, shape: Tuple[int, ...], rank: int) -> List[List[int]]:
        """``[start, stop)`` along every dim of the whole tensor of ``shape``
        that the device at ``rank`` holds."""
        index = [[0, int(s)] for s in shape]
        for dim, ways, c in self._cuts(rank):
            n = (index[dim][1] - index[dim][0]) // ways
            index[dim] = [index[dim][0] + c * n, index[dim][0] + (c + 1) * n]
        return index

    def writes(self, rank: int) -> bool:
        """Whether the device at ``rank`` is its piece's one writer: its
        coordinate is 0 along every mesh dim that does not shard the tensor."""
        return all(c == 0 for (_, size), p, c in
                   zip(self.mesh_shape, self.placements, self.coords(rank))
                   if not (p.is_shard() and size > 1))

    def local(self, full: torch.Tensor, rank: int) -> torch.Tensor:
        """The piece of the whole tensor ``full`` that the device at flat
        ``rank`` holds (a view; the tensor itself where nothing shards it).
        Bit for bit the slice of the whole."""
        for dim, (a, b) in enumerate(self.index(tuple(full.shape), rank)):
            if b - a != full.shape[dim]:
                full = full.narrow(dim, a, b - a)
        return full

    def assemble(self, pieces) -> torch.Tensor:
        """Inverse of :meth:`local`: the whole tensor from the pieces of
        every device of the mesh, in flat rank order (of a mesh whose one
        sharding dim is ``data``, the pieces of the ``data`` coordinates)."""
        pieces = list(pieces)
        n = math.prod(size for _, size in self.mesh_shape)
        if len(pieces) != n:
            raise ValueError(f"{len(pieces)} pieces for a mesh of {n} devices "
                             f"{dict(self.mesh_shape)}")
        # merge the innermost mesh dim first: each run of `size` pieces is one
        # piece of the next dim out
        for (_, size), p in reversed(list(zip(self.mesh_shape, self.placements))):
            runs = [pieces[i:i + size] for i in range(0, len(pieces), size)]
            pieces = [torch.cat(run, dim=p.dim) if p.is_shard() and size > 1 else run[0]
                      for run in runs]
        return pieces[0]


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
    family: Optional[str] = None   # the model's family (what check_plan reads)
    axes: PyTree = None            # the parameters' logical-axes tree
    # the whole width of the ``lru`` axis and the channels a split keeps
    # together (an RWKV head's: its group norm and bonus are per head)
    lru_width: int = 0
    lru_group: int = 1

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


def local_shape(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The shape of this rank's piece of a tensor of logical ``axes`` and
    whole ``shape`` on the mesh in scope, under the rule table in force and
    size-aware as :func:`arg_shardings_for_tree` (``shape`` itself outside
    a mesh)."""
    mesh = get_mesh()
    shape = tuple(int(n) for n in shape)
    if mesh is None:
        return shape
    return layout_for(_divisible_spec(spec_for(axes, _CURRENT_RULES), shape, mesh),
                      mesh).shard_shape(shape)


def batch_ways() -> int:
    """How many ways the rule table in force splits batch rows on the mesh
    in scope (1 outside one): a rank's rows times this is the whole batch."""
    mesh = get_mesh()
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    part = _CURRENT_RULES.get("batch")
    return math.prod(sizes.get(a, 1) for a in ((part,) if isinstance(part, str)
                                               else tuple(part or ())))


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


def _model_leaves(plan: ShardingPlan):
    """(tree name, path, layout) of every parameter and moment leaf that
    the plan shards over a ``model`` axis of two or more devices."""
    for name, tree in (("params", plan.params), ("opt.mu", plan.opt.mu),
                       ("opt.nu", plan.opt.nu)):
        for path, lay in iter_layouts(tree):
            if lay.model_dim is not None:
                yield name, path, lay


def _axes_at(axes: PyTree, path: str):
    for k in path.split("/"):
        axes = axes[k]
    return axes


def check_plan(plan: ShardingPlan, processes: Optional[int] = None) -> ShardingPlan:
    """Raise ``NotImplementedError`` where ``plan`` needs what the port does
    not run (:data:`SHARDED_WEIGHTS`): more devices than ``processes``; a
    leaf sharded over ``model`` in a family other than :data:`TP_FAMILIES`,
    or on a logical axis other than :data:`TP_AXES`; an ``lru`` piece of a
    width that is not a whole number of ``plan.lru_group`` channels; query
    heads that the rules keep off ``model`` beside such leaves.  Leaves
    whole on every device, sharded over ``data`` (ZeRO-3) or over ``model``
    (tensor and expert parallelism) pass, query heads the axis does not
    divide among them (whole weights, a block of heads a rank); return the
    plan."""
    if processes is not None and plan.n_devices > processes:
        raise NotImplementedError(
            f"the plan spans {plan.n_devices} devices over {processes} process(es): a "
            f"process drives one device; several devices a process is {SHARDED_WEIGHTS}")
    for name, path, lay in _model_leaves(plan):
        m = dict(lay.mesh_shape)["model"]
        where = (f"the plan shards {name} leaf {path!r} over 'model' on {m} devices (spec "
                 f"{lay.spec} on mesh {dict(lay.mesh_shape)})")
        if plan.family not in TP_FAMILIES:
            raise NotImplementedError(
                f"{where}, but the {plan.family} family runs no tensor parallelism "
                f"(ported: {TP_FAMILIES}): {SHARDED_WEIGHTS}")
        if plan.axes is not None:
            axis = _axes_at(plan.axes, path)[lay.model_dim]
            if axis not in TP_AXES:
                raise NotImplementedError(
                    f"{where} at its {axis!r} axis; a tensor-parallel forward reads model "
                    f"shards of {TP_AXES} only: {SHARDED_WEIGHTS}")
            if axis == "lru" and (plan.lru_width // m) % plan.lru_group:
                raise NotImplementedError(
                    f"{where}: a rank's {plan.lru_width // m} of {plan.lru_width} lru "
                    f"channels are not whole heads of {plan.lru_group} (the group norm and "
                    f"the bonus u are per head): {SHARDED_WEIGHTS}")
        if plan.axes is not None and not heads_on_model(plan.rules):
            for path, axes in _iter_axes(plan.axes):
                if "heads" in axes:
                    raise NotImplementedError(
                        f"{where}, while the rules keep the query heads of {path!r} whole "
                        f"(heads: {plan.rules.get('heads')!r}): {SHARDED_WEIGHTS}")
    return plan


def heads_on_model(rules: Dict[str, MeshAxes]) -> bool:
    """Whether ``rules`` put the query heads on ``model`` (split where the
    axis divides them, else a padded split of whole weights)."""
    part = rules.get("heads")
    return "model" in ((part,) if isinstance(part, str) else tuple(part or ()))


def _iter_axes(tree: PyTree, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _iter_axes(v, path)
        else:
            yield path, v


# ---------------------------------------------------------------------------
# The rule table in force
# ---------------------------------------------------------------------------

_CURRENT_RULES: Dict[str, MeshAxes] = make_rules()
_CONSTRAIN = True


def set_rules(rules: Dict[str, MeshAxes], constrain: bool = True) -> None:
    global _CURRENT_RULES, _CONSTRAIN
    _CURRENT_RULES = rules
    _CONSTRAIN = constrain


def get_rules() -> Dict[str, MeshAxes]:
    return _CURRENT_RULES


@contextlib.contextmanager
def use_rules(rules: Dict[str, MeshAxes], constrain: bool = True):
    """Temporarily install a rule table and the constrain switch (and
    restore the previous ones): the step runs the model under its plan's
    table, so :func:`with_logical_constraint` resolves against the table
    that laid out the weights."""
    global _CURRENT_RULES, _CONSTRAIN
    prev = _CURRENT_RULES, _CONSTRAIN
    _CURRENT_RULES, _CONSTRAIN = rules, constrain
    try:
        yield
    finally:
        _CURRENT_RULES, _CONSTRAIN = prev


# ---------------------------------------------------------------------------
# The mesh in scope, and the activations' layout contract
# ---------------------------------------------------------------------------

_MESH: Any = None
# logical activation axis -> its whole size, for the forward in progress
_SIZES: Dict[str, int] = {}


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the block on ``mesh`` (a ``DeviceMesh`` over the process group's
    ranks, one device a rank): the models shard their products over its
    ``model`` axis (the reference's ``set_mesh``)."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def get_mesh():
    """The mesh in scope, or None (the reference's ``get_abstract_mesh``)."""
    return _MESH


@contextlib.contextmanager
def logical_sizes(sizes: Dict[str, int]):
    """The whole sizes of logical activation axes (``act_heads``, ...)
    that :func:`with_logical_constraint` holds a rank's pieces to."""
    global _SIZES
    prev, _SIZES = _SIZES, {**_SIZES, **sizes}
    try:
        yield
    finally:
        _SIZES = prev


_WARNED_CONSTRAINTS: set = set()


def reset_constraint_warnings() -> None:
    """Clear the warn-once cache of :func:`with_logical_constraint` (it is
    process-global: a run warns once a (spec, mesh), ever; a test that
    asserts the warning clears it first)."""
    _WARNED_CONSTRAINTS.clear()


def _warn_constraint_skipped(axes, clean, mesh, why: str) -> None:
    sizes = mesh_axis_sizes(mesh)
    key = (tuple(axes), tuple(tuple(p) if isinstance(p, tuple) else p for p in clean),
           tuple(sizes), tuple(sizes.values()))
    if key in _WARNED_CONSTRAINTS:
        return
    _WARNED_CONSTRAINTS.add(key)
    warnings.warn(f"sharding constraint for logical axes {tuple(axes)} (spec {tuple(clean)}) "
                  f"skipped on mesh {sizes}: {why}", RuntimeWarning, stacklevel=3)


def with_logical_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The layout contract of an activation, by logical axis names (the
    reference's ``with_sharding_constraint`` by names).

    A no-op outside a mesh scope or under ``constrain=False``.  Otherwise
    the names resolve against the table in force, dropping mesh axes the
    mesh lacks; a dim named on mesh axes of ``n`` devices whose whole size
    is known (:func:`logical_sizes`) must hold ``whole / n`` of it on the
    rank.  The port's collectives move the data
    (:mod:`repro_torch.distributed.tensor`); this moves nothing and returns
    ``x``.  The expected mismatches, more names than dims, or a whole size
    that ``n`` does not divide (the rank then holds it whole), warn once a
    (names, spec, mesh); a rank holding another piece than the contract's
    raises ``ValueError``."""
    mesh = get_mesh()
    if not _CONSTRAIN or mesh is None:
        return x
    sizes = mesh_axis_sizes(mesh)
    clean = []
    for part in spec_for(tuple(axes), _CURRENT_RULES):
        kept = tuple(a for a in ((part,) if isinstance(part, str) else tuple(part or ()))
                     if a in sizes)
        clean.append(kept[0] if len(kept) == 1 else (kept or None))
    if len(clean) > x.dim():
        _warn_constraint_skipped(axes, clean, mesh,
                                 f"{len(clean)} sharded parts on a {x.dim()}-D tensor")
        return x
    for i, part in enumerate(clean):
        whole = _SIZES.get(axes[i])
        n = math.prod(sizes[a] for a in ((part,) if isinstance(part, str) else part or ()))
        if whole is None or n == 1:
            continue
        want = whole // n if whole % n == 0 else whole
        if whole % n:
            _warn_constraint_skipped(axes, clean, mesh,
                                     f"dim {i} ({axes[i]}, {whole}) is not divisible by {n}")
        if x.shape[i] != want:
            raise ValueError(f"dim {i} of a {tuple(x.shape)} activation named {axes[i]!r} "
                             f"holds {x.shape[i]} of {whole} on a rank of a {n}-way split; "
                             f"the layout contract says {want}")
    return x
