"""Parameter builder (port of :mod:`repro.models.param`).

One code path yields concrete parameters, abstract ones (``meta`` tensors, no
memory), and a parallel tree of logical-axis names per leaf, e.g.
``("layers", "embed", "mlp")``.  The axis tree is kept for the sharding slice
of the port.  Leaves keep the JAX layouts: ``wq`` is (d, H, hd), stacked
blocks are (L, ...).

Initializers draw from one seeded ``torch.Generator`` on the target device,
leaf after leaf in creation order.  They never reproduce ``jax.random``'s
numbers: tests carry JAX weights across with :func:`repro_torch.interop.params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

PyTree = Any
# (generator, shape, dtype, device, stacked) -> tensor; the first ``stacked``
# dims of ``shape`` are layer dims
Init = Callable[[Optional[torch.Generator], Tuple[int, ...], torch.dtype, torch.device, int],
                torch.Tensor]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _draw(gen, shape, dtype, device, stacked, draw_f32) -> torch.Tensor:
    """``draw_f32(gen, shape, device)`` (a float32 tensor) cast to ``dtype``.
    A leaf whose first ``stacked`` dims are layer dims is drawn one layer
    slice at a time into the preallocated result, so the float32 draw never
    exceeds one slice."""
    if stacked == 0:
        return draw_f32(gen, shape, device).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in out.view(-1, *shape[stacked:]):
        part.copy_(draw_f32(gen, shape[stacked:], device))
    return out


def _normal(gen, shape, dtype, device, std: float, stacked: int = 0) -> torch.Tensor:
    """N(0, std^2) drawn in float32 and cast to ``dtype``, slice by slice."""
    def draw(g, s, dev):
        return torch.randn(s, generator=g, dtype=torch.float32, device=dev).mul_(std)

    return _draw(gen, shape, dtype, device, stacked, draw)


def normal_init(stddev: float = 0.02) -> Init:
    def init(gen, shape, dtype, device, stacked=0):
        return _normal(gen, shape, dtype, device, stddev, stacked)

    return init


def uniform_init(lo: float, hi: float) -> Init:
    """U[lo, hi) drawn in float32 and cast to ``dtype``, slice by slice."""
    def draw(g, s, dev):
        return torch.rand(s, generator=g, dtype=torch.float32, device=dev).mul_(hi - lo).add_(lo)

    def init(gen, shape, dtype, device, stacked=0):
        return _draw(gen, shape, dtype, device, stacked, draw)

    return init


def scaled_init(fan_in_axis: int = -2) -> Init:
    """LeCun-style 1/sqrt(fan_in) initializer.  Fan-in is read from the whole
    shape, layer dims included, as the reference reads it."""

    def init(gen, shape, dtype, device, stacked=0):
        fan_in = shape[fan_in_axis] if len(shape) >= 2 else shape[-1]
        return _normal(gen, shape, dtype, device, 1.0 / math.sqrt(max(1, fan_in)), stacked)

    return init


def constant_init(value: float) -> Init:
    def init(gen, shape, dtype, device, stacked=0):
        return torch.full(shape, value, dtype=dtype, device=device)

    return init


def ones_init() -> Init:
    return constant_init(1.0)


def zeros_init() -> Init:
    return constant_init(0.0)


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Collects parameters into a nested-dict tree with logical axis metadata.

    ``abstract=True`` makes ``meta`` tensors: shapes and dtypes only.
    """

    def __init__(self, generator: Optional[torch.Generator], abstract: bool,
                 dtype: torch.dtype, device: torch.device):
        self.generator = generator
        self.abstract = abstract
        self.dtype = dtype
        self.device = device
        self.params: Dict[str, Any] = {}
        self.axes: Dict[str, Any] = {}

    def scope(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.generator, self.abstract, self.dtype, self.device)
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child

    def param(
        self,
        name: str,
        shape: Sequence[int],
        axes: Tuple[Optional[str], ...],
        init: Optional[Init] = None,
        dtype: Optional[torch.dtype] = None,
        stacked: int = 0,
    ) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {tuple(shape)} vs axes {axes}")
        dtype = dtype or self.dtype
        shape = tuple(int(s) for s in shape)
        if self.abstract:
            leaf = torch.empty(shape, dtype=dtype, device="meta")
        else:
            leaf = (init or normal_init())(self.generator, shape, dtype, self.device, stacked)
        self.params[name] = leaf
        self.axes[name] = tuple(axes)
        return leaf


class StackedBuilder:
    """View over a ParamBuilder that prepends a stacked-layer dim to every param
    (shape ``(L, ...)``, logical axes ``("layers", ...)``)."""

    def __init__(self, inner, n: int):
        self._inner = inner
        self._n = n

    def scope(self, name: str) -> "StackedBuilder":
        return StackedBuilder(self._inner.scope(name), self._n)

    def param(self, name, shape, axes, init=None, dtype=None):
        return self._inner.param(
            name, (self._n, *shape), ("layers", *axes), init=init, dtype=dtype,
            stacked=1,
        )


def stacked(b, n: int) -> StackedBuilder:
    return StackedBuilder(b, n)


def build(
    fn: Callable[[ParamBuilder], None],
    *,
    seed: Optional[int] = None,
    abstract: bool = False,
    dtype: torch.dtype = torch.float32,
    device: torch.device = torch.device("cpu"),
) -> Tuple[PyTree, PyTree]:
    """Run ``fn(builder)`` and return ``(params, logical_axes)`` trees.

    Concrete leaves are drawn from ``torch.Generator(device).manual_seed(seed)``.
    """
    gen = None
    if not abstract:
        gen = torch.Generator(device=device)
        gen.manual_seed(0 if seed is None else int(seed))
    b = ParamBuilder(gen, abstract, dtype, torch.device(device))
    fn(b)
    return b.params, b.axes

