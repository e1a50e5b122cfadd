"""Ref-counted block allocator with hash-based prefix caching (a copy of
``repro.serve.block_cache``: pure Python, no framework).

The allocator manages *logical* block ids in ``[0, num_blocks)``; what a block
physically holds is the adapter's business (:mod:`repro_torch.serve.adapters`): a
page of KV rows for attention families, a recurrent-state snapshot for
rwkv6/rglru.  The STANNIS discipline — compute where the data lives instead of
moving it — shows up here as *don't recompute what is already resident*: a
prefix that hashes to a live block is reused byte-for-byte instead of being
prefilled again.

Lifecycle of a block:

    free ──allocate()──► live (ref=1) ──decref() to 0──┬─► cached  (hashed:
      ▲                      ▲                          │   evictable LRU, but
      │                      └──lookup(hash) re-refs────┘   still a hit target)
      └──────────── evicted when allocate() finds no free block ◄┘

``lookup`` resurrects cached blocks (a prefix-cache hit on a finished
request's blocks), so the pool behaves like an LRU cache of the most recent
prefixes under allocation pressure.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple


def hash_block(prev_hash: int, tokens: Sequence[int]) -> int:
    """Chained content hash: identifies the FULL prefix ending at this block."""
    return hash((prev_hash, tuple(int(t) for t in tokens)))


def hash_chain(tokens: Sequence[int], block_size: int) -> List[int]:
    """One chained hash per *full* block of ``tokens`` (the trailing partial
    block is not hashable — it can't be shared)."""
    out: List[int] = []
    h = 0
    for i in range(len(tokens) // block_size):
        h = hash_block(h, tokens[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out


@dataclasses.dataclass
class CacheStats:
    queries: int = 0          # prefix-cache probes (per block)
    hit_blocks: int = 0       # probes that found a resident block
    allocated: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hit_blocks / self.queries if self.queries else 0.0


class BlockAllocator:
    """Fixed pool of ``num_blocks`` ref-counted blocks + hash → block map."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(num_blocks))
        self._cached: "OrderedDict[int, int]" = OrderedDict()  # block_id -> hash (LRU)
        self._ref: Dict[int, int] = {}                         # block_id -> refcount
        self._hash_of: Dict[int, int] = {}                     # block_id -> hash
        self._table: Dict[int, int] = {}                       # hash -> block_id
        self.stats = CacheStats()

    # -- introspection --------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Blocks allocatable right now (never-used + evictable cached)."""
        return len(self._free) + len(self._cached)

    @property
    def num_live(self) -> int:
        return len(self._ref)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    # -- prefix cache ---------------------------------------------------------

    def lookup(self, h: int) -> Optional[int]:
        """Hash probe.  A hit returns the block id with its refcount BUMPED
        (the caller now holds a reference and must ``decref`` eventually)."""
        self.stats.queries += 1
        bid = self._table.get(h)
        if bid is None:
            return None
        self.stats.hit_blocks += 1
        if bid in self._cached:            # resurrect an evictable block
            del self._cached[bid]
            self._ref[bid] = 1
        else:
            self._ref[bid] += 1
        return bid

    def contains(self, h: int) -> bool:
        return h in self._table

    # -- alloc / free ---------------------------------------------------------

    def allocate(self, h: Optional[int] = None) -> Optional[int]:
        """Take a block (ref=1), optionally registering it under hash ``h``.
        Returns None when every block is referenced (pool exhausted)."""
        if self._free:
            bid = self._free.popleft()
        elif self._cached:
            bid, old_h = self._cached.popitem(last=False)   # evict LRU
            del self._table[old_h]
            del self._hash_of[bid]
            self.stats.evictions += 1
        else:
            return None
        self._ref[bid] = 1
        if h is not None:
            if h in self._table:
                raise ValueError(f"hash {h} already registered")
            self._table[h] = bid
            self._hash_of[bid] = h
        self.stats.allocated += 1
        return bid

    def incref(self, block_id: int) -> None:
        if block_id not in self._ref:
            raise ValueError(f"block {block_id} is not live")
        self._ref[block_id] += 1

    def decref(self, block_id: int) -> None:
        """Release one reference.  At zero, a hashed block becomes *cached*
        (still a lookup target, evictable LRU); an anonymous one goes free."""
        n = self._ref.get(block_id)
        if n is None:
            raise ValueError(f"block {block_id} is not live")
        if n > 1:
            self._ref[block_id] = n - 1
            return
        del self._ref[block_id]
        h = self._hash_of.get(block_id)
        if h is None:
            self._free.append(block_id)
        else:
            self._cached[block_id] = h

    free = decref
