"""What a step costs on the card, counted without running it.

* The kernels' least work: :func:`attention_ops`, :func:`wkv6_ops` and the
  bound of a call (:func:`bound`: bytes over the memory rate or operations
  over the peak rate of their type, the larger), which ``chip_smoke.py``
  prints beside each kernel's time.
* :class:`CostMode`: a dispatch mode over a step traced on the ``meta``
  device that counts its FLOPs (``torch.utils.flop_counter``), the bytes
  each aten op reads and writes, and the peak of live bytes: the dry run's
  stand-ins for XLA's ``cost_analysis`` and ``memory_analysis``
  (:mod:`repro_torch.launch.dryrun`).  The ops of
  :mod:`repro_torch.kernels.ops` run no arithmetic on ``meta`` tensors: each
  returns its kernel's outputs and reports the kernel's work through
  :func:`kernel_cost`, from the same formulas.

Torch counts every aten op apart (nothing is fused), so the byte count is
larger than what a compiler that fuses elementwise chains would move.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.device import HBM_BW, PEAK_FLOPS

WKV6_CHUNK = 16       # csrc/rwkv6_scan.cu's chunk of steps


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """The least ms a call could take on the card, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def wkv6_ops(B: int, S: int, H: int, D: int) -> float:
    """The WKV-6 scan's least operations, the chunked form's (on the bf16
    tensor cores): per step of a (b, h), 2 D^2 for r (.) decay times the
    carried state, 2 D^2 for the state's update and 2 L D for the
    intra-chunk term and its product with v (its triangle, L = 16)."""
    return (4.0 * D * D + 2.0 * WKV6_CHUNK * D) * B * H * S


def attention_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int] = None) -> int:
    """Live (query, key) pairs of one head: query i sits at position
    ``Skv - Sq + i`` and, when causal, sees the ``min(position + 1, window)``
    keys ending at it; otherwise every key."""
    if not causal:
        return Sq * Skv
    off, w = Skv - Sq, min(window or Skv, Skv)
    k = max(0, min(w - off, Sq))              # queries that see fewer than w keys
    return k * off + k * (k + 1) // 2 + (Sq - k) * w


def attention_ops(B: int, H: int, Sq: int, Skv: int, D: int, causal: bool,
                  window: Optional[int] = None) -> float:
    """Two products of 2 D operations per live (query, key) pair."""
    return 4.0 * D * B * H * attention_pairs(Sq, Skv, causal, window)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# counting a traced step
# ---------------------------------------------------------------------------

_ACTIVE: List["CostMode"] = []

# ops that make a tensor without writing it, or only look at one
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_local_scalar_dense"}


def kernel_cost(name: str, flops: float, moved: float) -> None:
    """Called by an op's meta route in place of its kernel: adds the
    kernel's operations and the bytes it reads and writes to the active
    count (if any)."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(name, flops, moved)


class _TrafficMode(TorchDispatchMode):
    def __init__(self, owner: "CostMode"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.owner.on_op(func, args, kwargs or {}, out)
        return out


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class CostMode:
    """``with CostMode() as c: step(...)`` -> ``c.flops``, ``c.bytes``,
    ``c.peak``, ``c.kernels``.

    Live bytes follow tensor storages: a storage counts from the op that
    made it until Python frees it (a weak reference's finalizer), so the
    saved-for-backward tensors, the remat recompute and the optimizer's
    temporaries all count as long as they live.  Tensors made before the
    mode (weights, optimizer state, the batch, a cache) count once passed
    to :meth:`track` (``argument_bytes``)."""

    def __init__(self):
        self.flop_counter = FlopCounterMode(display=False)
        self.traffic = _TrafficMode(self)
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._storages: Dict[int, Any] = {}

    # -- live bytes ----------------------------------------------------------
    def _free(self, key: int, size: int) -> None:
        self._storages.pop(key, None)
        self.live -= size

    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage from now until it is freed; -> its bytes
        (0 if it is counted already)."""
        st = t.untyped_storage()
        key = id(st)
        ref = self._storages.get(key)
        if ref is not None and ref() is st:
            return 0
        size = st.nbytes()
        self._storages[key] = weakref.ref(st)
        weakref.finalize(st, self._free, key, size)
        self.live += size
        self.peak = max(self.peak, self.live)
        return size

    def track(self, *trees: Any) -> None:
        for tree in trees:
            for t in _tensors(tree):
                self.argument_bytes += self._hold(t)

    # -- per op ----------------------------------------------------------------
    def on_op(self, func, args, kwargs, out) -> None:
        outs = list(_tensors(out))
        for t in outs:
            self._hold(t)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return
        self.bytes += sum(t.numel() * t.element_size()
                          for t in (*_tensors(args), *_tensors(kwargs), *outs))

    def add_kernel(self, name: str, flops: float, moved: float) -> None:
        self.kernel_flops += flops
        self.bytes += moved
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += moved

    @property
    def flops(self) -> float:
        return float(self.flop_counter.get_total_flops()) + self.kernel_flops

    def __enter__(self) -> "CostMode":
        self.flop_counter.__enter__()
        self.traffic.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        self.traffic.__exit__(*exc)
        self.flop_counter.__exit__(*exc)
