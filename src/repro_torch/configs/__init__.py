"""Ported architecture configs (published dims) + reduced smoke variants.

``get_config(name)`` -> full ModelConfig; ``smoke_config(name)`` -> tiny
same-family config for CPU tests.  ``ARCHS`` lists only the archs the port
runs so far; the others are queued in ROADMAP.md.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = ["deepseek-7b", "qwen3-moe-30b-a3b", "dbrx-132b", "rwkv6-7b",
                    "recurrentgemma-2b"]

_MODULES: Dict[str, str] = {
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet; ported: {ARCHS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _mod(name).SMOKE
