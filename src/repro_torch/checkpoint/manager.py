"""Atomic, CRC-checked, async checkpointing (port of
:mod:`repro.checkpoint.manager`).

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

Multi-process (cluster) checkpoints (:class:`ClusterCheckpointManager`)
keep the reference's single writer for every byte.  Where every replica
holds the whole state, the PRIMARY (process 0) writes the whole checkpoint
through the same atomic save, between a barrier that every process reaches
at the step and one that holds them until it is published.  Under ZeRO-3
(the manager's ``layouts`` shard leaves over ``data``) every process runs
:func:`save_process`: a replicated leaf is written whole by the primary
only, a sharded leaf as one *chunk* file a rank (its shard, ``index`` the
[start, stop) of every dim), each into the shared ``step_N.tmp/`` with a
partial ``manifest.p<N>.json``; after a barrier the primary's
:func:`finalize_process_save` merges the partials, checks that the chunks
tile every leaf, writes the standard manifest (a chunked entry carries a
``chunks`` list, as the reference's) and publishes atomically.
:func:`restore` reads both layouts, and with ``layouts`` places each leaf
straight onto a plan of any mesh: the piece at the rank's coordinates
(chunks sharded over ``data``, ``model`` or both).
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
        return all(os.path.isfile(os.path.join(path, f))
                   for e in manifest["entries"].values() for f, _ in _entry_files(e))
    except (OSError, ValueError, KeyError, TypeError):
        return False


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and not name.endswith(".tmp")
             and _is_valid(os.path.join(directory, name))]
    return max(steps) if steps else None


def _entry_files(e: Dict[str, Any]) -> List[Tuple[str, int]]:
    """(file, crc) pairs of an entry, whole-leaf or chunked."""
    if "chunks" in e:
        return [(c["file"], c["crc32"]) for c in e["chunks"]]
    return [(e["file"], e["crc32"])]


def _load_file(path: str, fn: str, crc: int, verify_crc: bool) -> np.ndarray:
    arr = np.load(os.path.join(path, fn))
    if verify_crc and _crc(arr) != crc:
        raise IOError(f"CRC mismatch for {fn} in {path}")
    return arr


def _load_entry(path: str, e: Dict[str, Any], verify_crc: bool,
                device: torch.device, layout=None, coord: int = 0) -> torch.Tensor:
    """One manifest entry as a tensor on ``device`` (chunks assembled), or,
    with a ``layout`` that shards it, the slice at ``coord``."""
    if "chunks" not in e:
        arr = _load_file(path, e["file"], e["crc32"], verify_crc)
    else:
        arr = None
        for c in e["chunks"]:
            piece = _load_file(path, c["file"], c["crc32"], verify_crc)
            if arr is None:
                arr = np.empty(tuple(e["shape"]), piece.dtype)
            arr[tuple(slice(a, b) for a, b in c["index"])] = piece
    if e["dtype"] == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if layout is not None and layout.n_shards > 1:
        t = layout.local(t, coord).clone()      # the slice alone, not a view of the whole
    return t.to(device)


def restore(directory: str, like: PyTree, *, step: Optional[int] = None,
            device: torch.device = torch.device("cpu"), verify_crc: bool = True,
            layouts: Optional[PyTree] = None, coord: int = 0) -> Tuple[PyTree, Dict[str, Any]]:
    """Restore into the structure of ``like`` (tensors of any device, meta
    included, or ints for ``OptState.step``), every tensor leaf placed on
    ``device`` with the dtype its manifest entry names.  ``layouts`` (a tree
    of :class:`~repro_torch.distributed.sharding.Layout` shaped like
    ``like``, a plan of any mesh) makes each sharded leaf the piece of the
    device at flat rank ``coord``.  Returns ``(tree, metadata)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    entries = manifest["entries"]
    lays = dict(_flatten_with_paths(layouts)) if layouts is not None else {}
    leaves = {}
    for key, ref in _flatten_with_paths(like):
        if key not in entries:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        e = entries[key]
        want = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
        if tuple(e["shape"]) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(e['shape'])} vs "
                             f"model {want}")
        t = _load_entry(path, e, verify_crc, torch.device(device), lays.get(key), coord)
        leaves[key] = t if isinstance(ref, torch.Tensor) else int(t)
    return _unflatten(like, leaves), manifest.get("metadata", {})


# ---------------------------------------------------------------------------
# multi-process saves with per-shard chunks
# ---------------------------------------------------------------------------


def _tmp_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}.tmp")


def save_process(directory: str, step: int, tree: PyTree, *, process_index: int,
                 num_processes: int, layouts: Optional[PyTree] = None, coord: int = 0,
                 metadata: Optional[Dict[str, Any]] = None) -> str:
    """One process's share of a coordinated multi-process save (the
    reference's ``save_process``).

    Into the SHARED ``step_N.tmp/``: every leaf that ``layouts`` does not
    shard, whole, from the primary alone; the piece of every leaf it does
    that the device at flat rank ``coord`` holds (over ``data``, ``model``
    or both), as a chunk, from the one rank at coordinate 0 along every
    mesh dim that does not shard it; and this process's partial manifest.
    Publishing is :func:`finalize_process_save`'s, after a barrier."""
    tmp = _tmp_dir(directory, step)
    os.makedirs(tmp, exist_ok=True)
    lays = dict(_flatten_with_paths(layouts)) if layouts is not None else {}
    entries: Dict[str, Any] = {}
    for key, arr, dtype in _snapshot(tree):
        fn_base = key.replace("/", "__")
        lay = lays.get(key)
        if lay is None or lay.n_shards == 1:
            if process_index != 0:
                continue                   # the primary is the single writer
            fn = fn_base + ".npy"
            _save_npy(os.path.join(tmp, fn), arr, dtype)
            entries[key] = {"file": fn, "shape": list(arr.shape), "dtype": dtype,
                            "crc32": _crc(arr)}
            continue
        if not lay.writes(coord):
            continue                       # another rank holds the same piece
        shape = list(lay.whole_shape(arr.shape))
        index = lay.index(shape, coord)
        fn = f"{fn_base}__p{process_index}_0.npy"
        _save_npy(os.path.join(tmp, fn), arr, dtype)
        entries[key] = {"chunks": [{"file": fn, "index": index, "crc32": _crc(arr)}],
                        "shape": shape, "dtype": dtype}
    partial = {"step": step, "process": process_index, "num_processes": num_processes,
               "entries": entries, "metadata": metadata or {}}
    with open(os.path.join(tmp, f"manifest.p{process_index}.json"), "w") as f:
        json.dump(partial, f, indent=1)
    return tmp


def finalize_process_save(directory: str, step: int, *, num_processes: int,
                          keys: Optional[List[str]] = None) -> str:
    """Merge the partial manifests and publish atomically (the reference's
    ``finalize_process_save``): the PRIMARY calls it after a barrier.
    Every process must have stamped its partial, every whole leaf must have
    one writer, and the chunks of a leaf must tile it, so no missing share
    is ever published as valid.  ``keys`` pins the expected leaf set."""
    tmp = _tmp_dir(directory, step)
    final = os.path.join(directory, f"step_{step:010d}")
    merged: Dict[str, Any] = {}
    metadata: Dict[str, Any] = {}
    for p in range(num_processes):
        pf = os.path.join(tmp, f"manifest.p{p}.json")
        if not os.path.isfile(pf):
            raise FileNotFoundError(f"process {p} never stamped its partial manifest in {tmp}")
        with open(pf) as f:
            partial = json.load(f)
        metadata.update(partial.get("metadata") or {})
        for key, e in partial["entries"].items():
            if "chunks" not in e:
                if key in merged:
                    raise ValueError(f"two writers for whole leaf {key!r}")
                merged[key] = e
                continue
            slot = merged.setdefault(key, {"chunks": [], "shape": e["shape"],
                                           "dtype": e["dtype"]})
            if "chunks" not in slot or slot["shape"] != e["shape"]:
                raise ValueError(f"mixed layouts for leaf {key!r}")
            slot["chunks"].extend(e["chunks"])
    if keys is not None:
        missing = set(keys) - set(merged)
        if missing:
            raise ValueError(f"checkpoint missing leaves: {sorted(missing)}")
    for key, e in merged.items():
        if "chunks" not in e:
            continue
        size = int(np.prod(e["shape"])) if e["shape"] else 1
        covered = sum(int(np.prod([b - a for a, b in c["index"]])) if c["index"] else 1
                      for c in e["chunks"])
        if covered != size:
            raise ValueError(f"chunks of {key!r} cover {covered} of {size} elements")
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"step": step, "entries": merged, "metadata": metadata}, f, indent=1)
    for p in range(num_processes):        # partials are staging-only
        os.remove(os.path.join(tmp, f"manifest.p{p}.json"))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                 # atomic publish
    return final


# ---------------------------------------------------------------------------
# the managers
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


@dataclasses.dataclass
class ClusterCheckpointManager(CheckpointManager):
    """Coordinated multi-process saves behind the CheckpointManager API.

    Each process holds one of these; ``save`` runs the single-writer
    protocol, so a ``Session`` in cluster mode checkpoints through exactly
    the same call sites as a single-process one.  Without sharded
    ``layouts``: barrier -> the primary's atomic save + rotate -> barrier.
    With them (ZeRO-3 or tensor parallelism; ``coord`` is this rank's flat
    index on the mesh):
    :func:`save_process` everywhere -> barrier -> the primary's
    :func:`finalize_process_save` + rotate -> barrier, and ``restore``
    gives this rank its shards.  Saves are synchronous — the cross-process
    barrier IS the stall, a background thread would just hide a torn save.
    A peer lost before the first barrier leaves nothing published.

    ``sync`` duck-types the coordinator transport (``barrier(tag)``);
    without one, an ``spmd`` group's ``dist.barrier``.  ``process_index ==
    0`` is the primary.
    """

    process_index: int = 0
    num_processes: int = 1
    sync: Any = None
    layouts: Optional[PyTree] = None
    coord: int = 0

    def _barrier(self, tag: str):
        if self.num_processes <= 1:
            return
        if self.sync is not None:
            self.sync.barrier(tag)
            return
        import torch.distributed as dist

        if dist.is_initialized():
            dist.barrier()

    def save(self, step: int, tree: PyTree, metadata=None, *, async_: bool = False):
        t0 = time.perf_counter()
        if self.layouts is not None:
            save_process(self.directory, step, tree, process_index=self.process_index,
                         num_processes=self.num_processes, layouts=self.layouts,
                         coord=self.coord, metadata=metadata)
            self._barrier(f"ckpt-stamp/{step}")
            if self.process_index == 0:
                finalize_process_save(self.directory, step, num_processes=self.num_processes)
                self._rotate()
        else:
            self._barrier(f"ckpt-enter/{step}")
            if self.process_index == 0:       # the primary is the single writer
                _write(self.directory, step, _snapshot(tree), metadata)
                self._rotate()
        self._barrier(f"ckpt-publish/{step}")
        self.last_snapshot_s, self.last_write_s = 0.0, time.perf_counter() - t0

    def restore(self, like: PyTree, *, step=None, device=torch.device("cpu")):
        self.wait()
        return restore(self.directory, like, step=step, device=device, layouts=self.layouts,
                       coord=self.coord)
