"""Model registry (port of :mod:`repro.models.api`): every family of the
reference (dense, MoE, rwkv6, rglru, encoder-decoder, vision-language).

``get_model(cfg)`` returns a :class:`Model` whose methods dispatch to the
family module.  ``forward`` and ``prefill`` pass side inputs through
(``frames=`` for encdec, ``patch_embeds=`` for vlm), as the reference's
``api.py:49-61`` does.  ``forward`` returns ``(logits, aux)``: the MoE
family's summed router loss, a float32 zero for every other family.

Under :func:`repro_torch.distributed.sharding.use_mesh` (the reference's
``set_mesh``) ``prefill`` and ``decode_step`` are tensor-parallel over the
mesh's ``model`` axis and ``init_cache`` allocates this rank's piece of
each leaf, as ``cache_logical_axes`` lays it out under the rule table in
force: the shard shape the reference's ``arg_shardings_for_tree`` gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import dense, encdec, moe, rglru, rwkv6, vlm
from repro_torch.models.config import ModelConfig

_FAMILIES = {"dense": dense, "moe": moe, "rglru": rglru, "rwkv6": rwkv6,
             "encdec": encdec, "vlm": vlm}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    mod: Any

    def init_params(self, seed: Optional[int] = None, abstract: bool = False,
                    dtype: Optional[torch.dtype] = None, device: DeviceLike = "cuda"):
        return self.mod.init_params(self.cfg, seed=seed, abstract=abstract,
                                    dtype=dtype, device=device)

    def forward(self, params, tokens, **inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward -> (logits, aux loss): a family whose forward
        returns a pair (MoE: the router's load-balance loss summed over its
        layers) passes it on; every other family's aux is a float32 zero."""
        out = self.mod.forward(params, self.cfg, tokens, **inputs)
        if isinstance(out, tuple):
            return out
        return out, torch.zeros((), dtype=torch.float32, device=out.device)

    def prefill(self, params, tokens, cache_len: int, **inputs):
        return self.mod.prefill(params, self.cfg, tokens, cache_len, **inputs)

    def decode_step(self, params, token, cache, pos):
        return self.mod.decode_step(params, self.cfg, token, cache, pos)

    def decode_writes(self, cache, pos, rows):
        """(leaf, index) pairs that cover everything ``decode_step`` writes
        for the batch ``rows`` (ints) at host positions ``pos``."""
        return self.mod.decode_writes(self.cfg, cache, pos, rows)

    def init_cache(self, batch: int, cache_len: int, dtype=None, device: DeviceLike = "cuda"):
        """A zeroed cache for ``batch`` rows (the whole batch); on a mesh,
        this rank's piece of each leaf (:func:`~repro_torch.distributed.
        sharding.local_shape` of its logical axes)."""
        if sharding.get_mesh() is None:
            return self.mod.init_cache(self.cfg, batch, cache_len, dtype=dtype, device=device)
        whole = self.mod.init_cache(self.cfg, batch, cache_len, dtype=dtype, device="meta")
        dev = resolve_device(device)
        return _zip(lambda t, axes: torch.zeros(sharding.local_shape(axes, t.shape),
                                                dtype=t.dtype, device=dev),
                    whole, self.cache_logical_axes())

    def cache_logical_axes(self):
        """The cache tree's logical axes, one tuple a leaf (the reference's
        ``Model.cache_logical_axes``)."""
        return self.mod.cache_logical_axes(self.cfg)


def _zip(fn, tree, axes):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, axes[k]) for k, v in tree.items()}
    return fn(tree, axes)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; known: {sorted(_FAMILIES)}")
    return Model(cfg=cfg, mod=_FAMILIES[cfg.family])
