"""Atomic, CRC-checked, async checkpointing for one process (port of the
single-process half of :mod:`repro.checkpoint.manager`).

Format (the reference's, byte for byte for the same values): one ``.npy``
per leaf, named by its '/'-joined key path with '/' -> '__', plus
``manifest.json`` with each leaf's file, shape, dtype and CRC32 and the
caller's metadata (step, schedule, batcher cursors).  Key paths follow JAX's
pytree order: dict keys sorted, ``OptState`` fields in order (``step``,
``mu``, ``nu``), ``None`` dropped, so a training state flattens to
``opt/step``, ``opt/mu/<path>``, ``opt/nu/<path>`` and ``params/<path>``.

  * Atomic: the leaves and manifest go to ``step_N.tmp/``, then one
    ``rename`` publishes ``step_N/``; a crash mid-write never hides the
    newest valid checkpoint.  ``latest_step`` skips a directory with no
    manifest or a missing leaf file; ``restore`` verifies every CRC.
  * bfloat16: numpy has no bf16, so a bf16 leaf is written as the
    reference writes an ``ml_dtypes`` array: raw 2-byte voids (``'<V2'``
    header) with ``"dtype": "bfloat16"`` in the manifest; restore reads the
    dtype from the manifest and reinterprets the bytes.
  * Async: :meth:`CheckpointManager.save` with ``async_=True`` copies every
    leaf to host memory it owns before it returns (the optimizer updates
    params and moments IN PLACE, so the next step would otherwise race the
    writer) and serializes on a background thread; ``wait()`` re-raises the
    thread's error.
  * Keep-K rotation bounds disk use.

The multi-process half (``save_process``, ``finalize_process_save``,
``ClusterCheckpointManager``) comes with cluster execution (ROADMAP item 13).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.optimizers import OptState

PyTree = Any

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# key paths (JAX's pytree order) and host snapshots
# ---------------------------------------------------------------------------


def _flatten_with_paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, OptState):
        return [kv for name in tree._fields
                for kv in _flatten_with_paths(getattr(tree, name), f"{prefix}{name}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like: PyTree, leaves: Dict[str, Any], prefix: str = "") -> PyTree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, OptState):
        return OptState(*(_unflatten(getattr(like, name), leaves, f"{prefix}{name}/")
                          for name in like._fields))
    return leaves[prefix[:-1]]


def _host_leaf(leaf: Any) -> np.ndarray:
    """One leaf as a host array that owns its memory (bf16 as ``V2``).

    A CPU tensor's ``.numpy()`` shares the tensor's memory, which the
    in-place optimizer overwrites on the next step, so it is cloned first.
    A card tensor is copied into pinned host memory without blocking;
    :func:`_snapshot` synchronizes once after all of them are queued.
    """
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type == "cpu":
            host = t.clone()
        else:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(np.dtype("V2"))
        return host.numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)        # OptState.step: JAX keeps a 0-d int32
    return np.array(leaf, copy=True)


def _snapshot(tree: PyTree) -> List[Tuple[str, np.ndarray, str]]:
    """(key, host array, manifest dtype) of every leaf; every device copy has
    finished when this returns."""
    out = []
    for key, leaf in _flatten_with_paths(tree):
        arr = _host_leaf(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        out.append((key, arr, _BF16 if bf16 else str(arr.dtype)))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes (read in place, not copied)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, except that a bf16 leaf gets the ``'<V2'`` header numpy
    writes for an ``ml_dtypes.bfloat16`` array (a plain ``V2`` array would
    get ``'|V2'``), so both packages write the same bytes."""
    if dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        np.ascontiguousarray(arr).tofile(f)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def _write(directory: str, step: int, snap: List[Tuple[str, np.ndarray, str]],
           metadata: Optional[Dict[str, Any]]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = {}
    for key, arr, dtype in snap:
        fn = key.replace("/", "__") + ".npy"
        _save_npy(os.path.join(tmp, fn), arr, dtype)
        entries[key] = {"file": fn, "shape": list(arr.shape), "dtype": dtype,
                        "crc32": _crc(arr)}
    manifest = {"step": step, "entries": entries, "metadata": metadata or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                 # atomic publish
    return final


def save(directory: str, step: int, tree: PyTree, *,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    return _write(directory, step, _snapshot(tree), metadata)


def _is_valid(path: str) -> bool:
    """A manifest that parses and names only files that exist (CRCs are
    checked by ``restore``)."""
    mf = os.path.join(path, _MANIFEST)
    if not os.path.isfile(mf):
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
        return all(os.path.isfile(os.path.join(path, e["file"]))
                   for e in manifest["entries"].values())
    except (OSError, ValueError, KeyError, TypeError):
        return False


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and not name.endswith(".tmp")
             and _is_valid(os.path.join(directory, name))]
    return max(steps) if steps else None


def _load_entry(path: str, e: Dict[str, Any], verify_crc: bool,
                device: torch.device) -> torch.Tensor:
    arr = np.load(os.path.join(path, e["file"]))
    if verify_crc and _crc(arr) != e["crc32"]:
        raise IOError(f"CRC mismatch for {e['file']} in {path}")
    if e["dtype"] == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def restore(directory: str, like: PyTree, *, step: Optional[int] = None,
            device: torch.device = torch.device("cpu"),
            verify_crc: bool = True) -> Tuple[PyTree, Dict[str, Any]]:
    """Restore into the structure of ``like`` (tensors of any device, meta
    included, or ints for ``OptState.step``), every tensor leaf placed on
    ``device`` with the dtype its manifest entry names.  Returns
    ``(tree, metadata)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    entries = manifest["entries"]
    leaves = {}
    for key, ref in _flatten_with_paths(like):
        if key not in entries:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        t = _load_entry(path, entries[key], verify_crc, torch.device(device))
        want = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
        if tuple(t.shape) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs model {want}")
        leaves[key] = t if isinstance(ref, torch.Tensor) else int(t)
    return _unflatten(like, leaves), manifest.get("metadata", {})


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CheckpointManager:
    """Keep-K rotation + async background saves.

    ``last_snapshot_s`` is the time the last ``save`` held its caller for
    the host copy; ``last_write_s`` the time its serialization, publish and
    rotation took (on the background thread when async).
    """

    directory: str
    keep: int = 3
    last_snapshot_s: float = 0.0
    last_write_s: float = 0.0
    _thread: Optional[threading.Thread] = None
    _error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree, metadata=None, *, async_: bool = False):
        t0 = time.perf_counter()
        snap = _snapshot(tree)                # on the caller's thread, always
        self.last_snapshot_s = time.perf_counter() - t0
        self.wait()

        def work():
            t1 = time.perf_counter()
            _write(self.directory, step, snap, metadata)
            self._rotate()
            self.last_write_s = time.perf_counter() - t1

        if not async_:
            work()
            return

        def guarded():
            try:
                work()
            except BaseException as e:        # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, like: PyTree, *, step=None, device=torch.device("cpu")):
        self.wait()
        return restore(self.directory, like, step=step, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _rotate(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.directory)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)
