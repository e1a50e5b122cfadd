"""Carry a JAX parameter tree (as numpy arrays) across into the port's tree.

``jax.random`` and ``torch`` draw different numbers from the same seed, so a
parity test builds weights once on the JAX side and hands them over leaf for
leaf, with the same names and the same layouts.  Nothing here imports JAX:
the caller converts its arrays with ``np.asarray`` first.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def to_torch(a: Any, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy-like array to a tensor; bfloat16 (``ml_dtypes``) goes by its bits."""
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(
    np_tree: Mapping[str, Any], device: DeviceLike = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    ``dtype`` casts every leaf when given; otherwise each keeps its dtype.
    """
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return to_torch(node, dev, dtype)

    return conv(np_tree)
