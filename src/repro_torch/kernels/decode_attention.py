"""Launch wrappers of the CUDA decode attention kernels
(``csrc/decode_attention.cu``): a contiguous cache or the pages of a shared
pool through a block table, each native or int8.

Replace ``repro/kernels/decode_attention.py::decode_attention``,
``::decode_attention_int8``, ``::paged_decode_attention`` and
``::paged_decode_attention_int8``.  Callers go through
:mod:`repro_torch.kernels.ops`.

Every entry splits a sequence's cache rows over blocks by one plan
(:func:`split_plan`): chunks of :func:`chunk_rows` rows counted from row 0.  Each
block leaves its partial softmax state in an f32 scratch allocated here, and
the last block of a (batch, kv head) merges them, found through a counter
buffer that the kernel leaves at 0 (one launch per call).  Scratch and
counters are kept per device and grown when a call needs more, so calls that
share them must run on one stream, as the port's do.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_aligned, check_attention_inputs

CHUNK = 64         # cache rows a block: a multiple of 16 and of the engine's page sizes 8 and 16
LONG_CHUNK = 128   # at head dim 256 with bf16 queries (see chunk_rows)


def chunk_rows(head_dim: int, dtype: torch.dtype) -> int:
    """Rows a block reads, fixed by the kernel that runs: 128 for the bf16
    (tensor-core) kernel at head dim 256, where a sequence of 2048 rows in 64
    chunks left 32 partials a head to merge and the merge dominated (0.060 ms
    against 0.027 at 128 on the H100); else 64, which keeps more blocks in
    flight (and fits the float32 kernel's shared memory).  Both routes take
    it from the same (head dim, dtype), so they cut alike."""
    return LONG_CHUNK if head_dim == 256 and dtype == torch.bfloat16 else CHUNK


class SplitPlan(NamedTuple):
    """How the decode kernels cut one sequence's cache rows over blocks."""

    capacity: int    # rows a sequence can hold
    chunk: int       # rows a block, counted from row 0
    n_chunks: int    # blocks along the rows: the grid's first axis

    def live(self, valid: int, window: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """``(chunk, first row, end row)`` of every block that reads a row,
        in ascending order (the order of the merge), for a sequence of
        ``valid`` rows (clamped to ``[0, capacity]``): the kernel's own
        arithmetic, row ``r`` live iff ``r < valid`` and, with a window,
        ``r >= valid - window``."""
        valid = min(max(int(valid), 0), self.capacity)
        lo = max(0, valid - window) if window else 0
        return [(c, max(c * self.chunk, lo), min((c + 1) * self.chunk, valid))
                for c in range(lo // self.chunk, -(-valid // self.chunk))]


@functools.lru_cache(maxsize=256)
def split_plan(capacity: int, page_size: int = 1, chunk: int = CHUNK) -> SplitPlan:
    """The split of a cache of ``capacity`` rows a sequence: the contiguous
    route passes ``(Skv, 1)``, the paged route ``(NP * page_size,
    page_size)``.  The cut is a fixed run of ``chunk`` rows from row 0, never
    a share of the capacity, and does not depend on the page size, so both
    routes cut a sequence at the same rows and sum it in the same order (their
    outputs agree bit for bit); at page sizes that divide ``chunk`` a block
    reads whole pages."""
    if page_size <= 0 or capacity <= 0 or capacity % page_size:
        raise ValueError(f"split_plan: capacity {capacity} is not a positive number of "
                         f"pages of {page_size}")
    if chunk <= 0 or chunk % 16:
        raise ValueError(f"split_plan: chunk {chunk} is not a positive multiple of 16")
    return SplitPlan(capacity, chunk, -(-capacity // chunk))


_BUFFERS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_buffers(q: torch.Tensor, Hkv: int, plan: SplitPlan):
    """The kernel's scratch, B * H * n_chunks * (D + 2) f32 values for the
    chunks' partial states (written before they are read in every call), and
    B * Hkv int32 counters, 0 between calls (the kernel's last block of each
    (batch, kv head) resets its own); one pair a device, grown on demand."""
    B, _, H, D = q.shape
    n_part, n_count = B * H * plan.n_chunks * (D + 2), B * Hkv
    part, counters = _BUFFERS.get(q.device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    if counters is None or counters.numel() < n_count:
        counters = torch.zeros(max(n_count, 1024), dtype=torch.int32, device=q.device)
    _BUFFERS[q.device] = (part, counters)
    return part, counters


def _check_cache(q, k, v, valid_len, what):
    B, one, H, D = q.shape
    if one != 1:
        raise ValueError(f"{what}: q must be (B, 1, H, D), got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{what}: H={H} not a multiple of Hkv={k.shape[2]}")
    if valid_len.shape != (B,) or valid_len.dtype != torch.int32:
        raise ValueError(f"{what}: valid_len must be (B,) int32")


def _window(window: Optional[int]) -> int:
    if window is not None and window <= 0:
        raise ValueError("decode_attention: window must be positive")
    return int(window or 0)


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, D)
    k: torch.Tensor,          # (B, Skv, Hkv, D) cache
    v: torch.Tensor,
    valid_len: torch.Tensor,  # (B,) int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    what = "decode_attention"
    check_attention_inputs(q, (("q", q), ("k", k), ("v", v), ("valid_len", valid_len)), what)
    _check_cache(q, k, v, valid_len, what)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype")
    B, _, H, D = q.shape
    out = torch.empty_like(q)
    check_aligned((("q", q), ("k", k), ("v", v), ("out", out)), what)
    plan = split_plan(k.shape[1], 1, chunk_rows(D, q.dtype))
    part, counters = _split_buffers(q, k.shape[2], plan)
    _build.call(
        "repro_decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid_len.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        B, k.shape[1], H, k.shape[2], D, plan.chunk, _window(window), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def decode_attention_int8(
    q: torch.Tensor,          # (B, 1, H, D)
    k: torch.Tensor,          # (B, Skv, Hkv, D) int8
    k_scale: torch.Tensor,    # (B, Skv, Hkv, 1) f32
    v: torch.Tensor,          # (B, Skv, Hkv, D) int8
    v_scale: torch.Tensor,    # (B, Skv, Hkv, 1) f32
    valid_len: torch.Tensor,  # (B,) int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    what = "decode_attention_int8"
    check_attention_inputs(
        q, (("q", q), ("k", k), ("k_scale", k_scale), ("v", v), ("v_scale", v_scale),
            ("valid_len", valid_len)), what)
    _check_cache(q, k, v, valid_len, what)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{what}: k and v must be int8")
    sshape = tuple(k.shape[:3]) + (1,)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != sshape or s.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be {sshape} float32")
    B, _, H, D = q.shape
    out = torch.empty_like(q)
    check_aligned((("q", q), ("k", k), ("k_scale", k_scale), ("v", v), ("v_scale", v_scale),
                   ("out", out)), what)
    plan = split_plan(k.shape[1], 1, chunk_rows(D, q.dtype))
    part, counters = _split_buffers(q, k.shape[2], plan)
    _build.call(
        "repro_decode_attention_int8", q.data_ptr(), k.data_ptr(), k_scale.data_ptr(),
        v.data_ptr(), v_scale.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), B, k.shape[1], H, k.shape[2], D, plan.chunk,
        _window(window), DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def _check_pages(q, k_pages, v_pages, block_table, valid_len, what):
    B, one, H, D = q.shape
    if one != 1:
        raise ValueError(f"{what}: q must be (B, 1, H, D), got {tuple(q.shape)}")
    if k_pages.dim() != 4 or k_pages.shape[3] != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} k_pages {tuple(k_pages.shape)} "
                         f"v_pages {tuple(v_pages.shape)}")
    if H % k_pages.shape[2]:
        raise ValueError(f"{what}: H={H} not a multiple of Hkv={k_pages.shape[2]}")
    if (block_table.dim() != 2 or block_table.shape[0] != B
            or block_table.dtype != torch.int32):
        raise ValueError(f"{what}: block_table must be (B, NP) int32, got "
                         f"{tuple(block_table.shape)} {block_table.dtype}")
    if block_table.shape[1] == 0:
        raise ValueError(f"{what}: a block table of no pages")
    if valid_len.shape != (B,) or valid_len.dtype != torch.int32:
        raise ValueError(f"{what}: valid_len must be (B,) int32")


def paged_decode_attention(
    q: torch.Tensor,            # (B, 1, H, D)
    k_pages: torch.Tensor,      # (P, page_size, Hkv, D) shared page pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (B, NP) int32 page ids per sequence
    valid_len: torch.Tensor,    # (B,) int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Entries of ``block_table`` for pages that hold live rows (below
    ``valid_len[b]``, and inside the window) must lie in ``[0, P)``; the
    others are never read."""
    what = "paged_decode_attention"
    check_attention_inputs(
        q, (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
            ("block_table", block_table), ("valid_len", valid_len)), what)
    _check_pages(q, k_pages, v_pages, block_table, valid_len, what)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{what}: q, k_pages, v_pages must share one dtype")
    B, _, H, D = q.shape
    out = torch.empty_like(q)
    check_aligned((("q", q), ("k_pages", k_pages), ("v_pages", v_pages), ("out", out)), what)
    NP, page = block_table.shape[1], k_pages.shape[1]
    plan = split_plan(NP * page, page, chunk_rows(D, q.dtype))
    part, counters = _split_buffers(q, k_pages.shape[2], plan)
    _build.call(
        "repro_paged_decode_attention", q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), B, NP, page, H, k_pages.shape[2], D,
        plan.chunk, _window(window), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


def paged_decode_attention_int8(
    q: torch.Tensor,            # (B, 1, H, D)
    k_pages: torch.Tensor,      # (P, page_size, Hkv, D) int8
    k_scales: torch.Tensor,     # (P, page_size, Hkv, 1) f32
    v_pages: torch.Tensor,      # (P, page_size, Hkv, D) int8
    v_scales: torch.Tensor,     # (P, page_size, Hkv, 1) f32
    block_table: torch.Tensor,  # (B, NP) int32
    valid_len: torch.Tensor,    # (B,) int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    what = "paged_decode_attention_int8"
    check_attention_inputs(
        q, (("q", q), ("k_pages", k_pages), ("k_scales", k_scales), ("v_pages", v_pages),
            ("v_scales", v_scales), ("block_table", block_table),
            ("valid_len", valid_len)), what)
    _check_pages(q, k_pages, v_pages, block_table, valid_len, what)
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"{what}: k_pages and v_pages must be int8")
    sshape = tuple(k_pages.shape[:3]) + (1,)
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(s.shape) != sshape or s.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be {sshape} float32")
    B, _, H, D = q.shape
    out = torch.empty_like(q)
    check_aligned((("q", q), ("k_pages", k_pages), ("k_scales", k_scales),
                   ("v_pages", v_pages), ("v_scales", v_scales), ("out", out)), what)
    NP, page = block_table.shape[1], k_pages.shape[1]
    plan = split_plan(NP * page, page, chunk_rows(D, q.dtype))
    part, counters = _split_buffers(q, k_pages.shape[2], plan)
    _build.call(
        "repro_paged_decode_attention_int8", q.data_ptr(), k_pages.data_ptr(),
        k_scales.data_ptr(), v_pages.data_ptr(), v_scales.data_ptr(),
        block_table.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), B, NP, page, H, k_pages.shape[2], D,
        plan.chunk, _window(window), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out
