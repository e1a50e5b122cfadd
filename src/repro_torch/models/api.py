"""Model registry (port of :mod:`repro.models.api`), dense family only.

``get_model(cfg)`` returns a :class:`Model` whose methods dispatch to the
family module.  Families the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import dense
from repro_torch.models.config import ModelConfig

_NOT_YET = {
    "moe": "ROADMAP 'MoE family'",
    "rglru": "ROADMAP 'Recurrent families'",
    "rwkv6": "ROADMAP 'Recurrent families'",
    "encdec": "ROADMAP 'Encoder-decoder and vision-language'",
    "vlm": "ROADMAP 'Encoder-decoder and vision-language'",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    mod: Any

    def init_params(self, seed: Optional[int] = None, abstract: bool = False,
                    dtype: Optional[torch.dtype] = None, device: DeviceLike = "cuda"):
        return self.mod.init_params(self.cfg, seed=seed, abstract=abstract,
                                    dtype=dtype, device=device)

    def forward(self, params, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward -> (logits, aux loss); aux is 0 for the dense family."""
        logits = self.mod.forward(params, self.cfg, tokens)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def prefill(self, params, tokens, cache_len: int):
        return self.mod.prefill(params, self.cfg, tokens, cache_len)

    def decode_step(self, params, token, cache, pos):
        return self.mod.decode_step(params, self.cfg, token, cache, pos)

    def init_cache(self, batch: int, cache_len: int, dtype=None, device: DeviceLike = "cuda"):
        return self.mod.init_cache(self.cfg, batch, cache_len, dtype=dtype, device=device)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        item = _NOT_YET.get(cfg.family, "ROADMAP 'Modules to port'")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet ({item})")
    return Model(cfg=cfg, mod=dense)
