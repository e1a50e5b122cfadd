"""Assigned input shapes and meta-device stand-ins for every model input
(port of :mod:`repro.configs.shapes`).

The four LM shapes (seq_len x global_batch):
  train_4k     4,096 x 256   -> the train step
  prefill_32k  32,768 x 32   -> prefill (serve)
  decode_32k   32,768 x 128  -> the serve step (1 token, KV cache of seq_len)
  long_500k    524,288 x 1   -> the serve step; sub-quadratic archs only

``input_specs`` returns tensors on the ``meta`` device (shapes and dtypes,
no storage) with the reference's shapes and dtypes; the dry run
(:mod:`repro_torch.launch.dryrun`) traces the step functions over them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.api import get_model
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, long_context=True),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k needs sub-quadratic attention."""
    if shape.long_context and cfg.family not in ("rglru", "rwkv6"):
        return False, "full quadratic attention at 512k is not deployable; skipped"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch: Optional[int] = None) -> Dict[str, Any]:
    """Meta-tensor stand-ins for the step function selected by ``shape.kind``
    (``batch`` replaces the shape's global batch, a one-card cut).

    train   -> {tokens, labels, loss_mask [, frames | patch_embeds]}
    prefill -> {tokens [, frames | patch_embeds]}
    decode  -> {token, pos, cache}
    """
    B, S = batch or shape.global_batch, shape.seq_len

    def side(out: Dict[str, Any]) -> Dict[str, Any]:
        if cfg.family == "encdec":
            out["tokens"] = _meta((B, S), torch.int32)
            out["frames"] = _meta((B, cfg.n_frames, cfg.d_model), cfg.dtype)
        elif cfg.family == "vlm":
            n_vis = min(cfg.n_vision_patches, S // 4)
            out["tokens"] = _meta((B, S - n_vis), torch.int32)
            out["patch_embeds"] = _meta((B, n_vis, cfg.d_model), cfg.dtype)
        else:
            out["tokens"] = _meta((B, S), torch.int32)
        return out

    if shape.kind == "train":
        return side({"labels": _meta((B, S), torch.int32),
                     "loss_mask": _meta((B, S), torch.float32)})
    if shape.kind == "prefill":
        return side({})
    if shape.kind == "decode":
        return {
            "token": _meta((B, 1), torch.int32),
            "pos": _meta((B,), torch.int32),
            "cache": get_model(cfg).init_cache(B, S, device=META),
        }
    raise ValueError(shape.kind)
