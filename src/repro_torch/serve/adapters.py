"""Per-family cache adapters (port of :mod:`repro.serve.adapters`): how a
request's context lives in engine memory.

Two layouts behind one interface (``admit`` / ``snapshot`` / ``publish`` /
``release``):

  * :class:`PagedKVAdapter` (attention families: dense, moe): the decode
    working set is a slot batch of contiguous KV rows, backed by a ref-counted
    page pool.  On admit, hash-chain prefix blocks that are resident in the
    pool are copied into the slot (no recompute); on prompt completion the
    slot's full blocks are published back to the pool for future hits.  Each
    pool leaf is (layers, num_blocks, block_size, Hkv, X), so ``pool[leaf][l]``
    is the (P, page_size, Hkv, D) page layout that
    :func:`repro_torch.kernels.ops.paged_decode_attention` reads through a
    block table.  The engine decodes over the gathered slot rows, as the
    reference's engine does.
  * :class:`RecurrentStateAdapter` (rwkv6, rglru): state is O(1) per
    request, so a "block" is a *state snapshot at a block-aligned prompt
    position*; an admit resumes from the deepest snapshot whose hash chain
    matches.

The caches are updated in place (the JAX package rebuilds them functionally),
so a pool write and a slot gather are index copies, a snapshot is a
``clone`` (a view would change under the live slot), and a prefix-cache hit
holds the very values computed the first time: bit-identical to a cold
prefill.  Both adapters are leaf-generic over the model's cache tree, so the
int8 KV layout (``{k, k_scale, v, v_scale}``) pages like a native one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from repro_torch.models.api import Model
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.serve.block_cache import BlockAllocator, hash_chain

PyTree = Any


def slot_slice(tree: PyTree, slot: int) -> PyTree:
    """Single-slot VIEW (the batch axis is 1 on every cache leaf): a step run
    on it writes the slot in place.  ``a[l, slot:slot + 1]`` is contiguous."""
    return tree_map(lambda a: a[:, slot:slot + 1], tree)


def slot_write(tree: PyTree, slot: int, sub: PyTree) -> None:
    """Copy ``sub`` (a single-slot tree) into ``slot`` of ``tree``, in place."""
    tree_map(lambda a, s: a[:, slot:slot + 1].copy_(s), tree, sub)


class PagedKVAdapter:
    """Slot-contiguous KV working set + ref-counted page pool (attention)."""

    def __init__(self, model: Model, *, n_slots: int, max_len: int,
                 num_blocks: int, block_size: int, device: torch.device):
        self.max_len = max_len
        self.cache = model.init_cache(n_slots, max_len, device=device)
        self.allocator = BlockAllocator(num_blocks, block_size)
        # pool leaf: (layers, num_blocks, block_size, *kv_dims)
        self.pool = tree_map(
            lambda a: torch.zeros((a.shape[0], num_blocks, block_size) + tuple(a.shape[3:]),
                                  dtype=a.dtype, device=a.device),
            self.cache,
        )
        self._held: Dict[int, List[int]] = {}

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        return prompt_len + max_new_tokens <= self.max_len

    def admit(self, slot: int, prompt: Sequence[int]) -> int:
        """Reuse resident prefix blocks; returns tokens already in the slot."""
        bs = self.allocator.block_size
        chain = hash_chain(prompt, bs)
        n_max = (len(prompt) - 1) // bs   # >= 1 token must remain to prefill
        hits: List[int] = []
        for d in range(min(len(chain), n_max)):
            bid = self.allocator.lookup(chain[d])
            if bid is None:
                break
            hits.append(bid)
        if hits:
            n = len(hits) * bs
            idx = torch.tensor(hits, dtype=torch.long, device=tree_leaves(self.pool)[0].device)
            for c, p in zip(tree_leaves(self.cache), tree_leaves(self.pool)):
                pages = p[:, idx]                        # (L, n_hit, bs, ...)
                c[:, slot, :n] = pages.reshape((p.shape[0], n) + tuple(p.shape[3:]))
        self._held[slot] = hits
        return len(hits) * bs

    def snapshot(self, slot: int, prompt: Sequence[int], pos: int) -> None:
        """No mid-prefill publishing for KV pages (rows land at completion)."""

    def publish(self, slot: int, prompt: Sequence[int]) -> None:
        """Copy the slot's full prompt blocks into the pool (best-effort)."""
        bs = self.allocator.block_size
        chain = hash_chain(prompt, bs)
        held = self._held.setdefault(slot, [])
        for d in range(len(held), len(chain)):
            bid = self.allocator.lookup(chain[d])
            if bid is None:
                bid = self.allocator.allocate(chain[d])
                if bid is None:            # pool exhausted: stop publishing
                    break
                for p, c in zip(tree_leaves(self.pool), tree_leaves(self.cache)):
                    p[:, bid] = c[:, slot, d * bs:(d + 1) * bs]
            held.append(bid)

    def release(self, slot: int) -> None:
        for bid in self._held.pop(slot, []):
            self.allocator.decref(bid)


class RecurrentStateAdapter:
    """O(1)-state slots + block-aligned state-snapshot prefix cache."""

    def __init__(self, model: Model, *, n_slots: int, max_len: int,
                 num_blocks: int, block_size: int, device: torch.device):
        self.cache = model.init_cache(n_slots, max_len, device=device)
        self.allocator = BlockAllocator(num_blocks, block_size)
        self._states: Dict[int, PyTree] = {}     # block_id -> (.., 1, ..) state
        self._held: Dict[int, List[int]] = {}

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        return True                              # state never grows

    def admit(self, slot: int, prompt: Sequence[int]) -> int:
        """Resume from the deepest matching state snapshot, if any."""
        bs = self.allocator.block_size
        chain = hash_chain(prompt, bs)
        n_max = (len(prompt) - 1) // bs
        for d in range(min(len(chain), n_max), 0, -1):
            bid = self.allocator.lookup(chain[d - 1])
            if bid is not None:
                slot_write(self.cache, slot, self._states[bid])
                self._held[slot] = [bid]
                return d * bs
        self._held[slot] = []
        return 0

    def snapshot(self, slot: int, prompt: Sequence[int], pos: int) -> None:
        """Publish the slot state after ``pos`` prompt tokens (block-aligned)."""
        bs = self.allocator.block_size
        if pos <= 0 or pos % bs or pos >= len(prompt):
            return
        h = hash_chain(prompt[:pos], bs)[-1]
        if self.allocator.contains(h):
            return
        bid = self.allocator.allocate(h)
        if bid is None:
            return
        # a copy: the slot's view would change under the stored snapshot
        self._states[bid] = tree_map(torch.clone, slot_slice(self.cache, slot))
        self._held.setdefault(slot, []).append(bid)

    def publish(self, slot: int, prompt: Sequence[int]) -> None:
        """Snapshots happen during prefill; nothing to flush at completion."""

    def release(self, slot: int) -> None:
        for bid in self._held.pop(slot, []):
            self.allocator.decref(bid)


def make_adapter(model: Model, *, n_slots: int, max_len: int,
                 num_blocks: int, block_size: int, device: torch.device):
    family = model.cfg.family
    if family in ("rwkv6", "rglru"):
        cls = RecurrentStateAdapter
    elif family in ("dense", "moe"):
        cls = PagedKVAdapter
    else:
        raise NotImplementedError(
            f"ServeEngine does not support family {family!r} yet "
            "(encdec/vlm decode needs side inputs; use ServeSession)"
        )
    return cls(model, n_slots=n_slots, max_len=max_len,
               num_blocks=num_blocks, block_size=block_size, device=device)
