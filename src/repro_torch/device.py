"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and no card
    is visible.  The port never carries on on the CPU by itself.

    TF32 is switched off for float32 matrix products and cuDNN convolutions,
    so a float32 run on the card keeps full float32 precision and can be held
    to the CPU path and to the JAX package.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device='cuda' requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch supports 'cuda' and 'cpu', got {dev}")
    return dev
