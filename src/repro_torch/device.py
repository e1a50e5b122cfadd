"""Device selection shared by every entry point of the port, and the card's peaks."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

# NVIDIA H100 80GB HBM3 (SXM), power limit 700 W: data-sheet peaks
PEAK_FLOPS_BF16 = 989e12        # dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12          # float32 FMA on the CUDA cores, FLOP/s
HBM_BW = 3.35e12                # device memory, bytes/s
NVLINK_BW = 450e9               # NVLink 4, bytes/s a direction (the collective term)
HBM_BYTES = 85_017_493_504     # torch.cuda.get_device_properties(0).total_memory on the card
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and no card
    is visible.  The port never carries on on the CPU by itself.  ``meta``
    (shapes and dtypes, no storage) is what the dry run traces on.

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
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch supports 'cuda', 'cpu' and 'meta', got {dev}")
    return dev
