"""Spool codecs: how :class:`~repro_torch.storage.flash.FlashDevice` lays token
bytes on flash.

The paper's discipline is to move fewer bytes off the medium; for an LM
corpus the shard payload is *token ids*, and ids must survive the round
trip **bit-exactly** — the flash==synthetic identity is a custody invariant
(a lossy int8+scale scheme a la ``kernels/quantize.py`` would round ids to
the nearest multiple of ``(vocab-1)/127`` ≈ 8 tokens at vocab 1024, silently
corrupting the corpus).  So "int8 on disk" here is the *lossless* narrow
integer codec: ids fitting one byte are spooled as ``u8`` (4x fewer bytes
than the legacy ``i32`` layout), two-byte vocabularies as ``u16`` (2x), and
the device widens back to ``int32`` during ``assemble`` — the in-device
"dequantize" of the mmap read path.  ``auto`` picks the narrowest width the
vocabulary fits.

Codecs only change the bytes AT REST on the device's own flash; the
assembled batches are identical, so custody rules, quarantine shredding,
and cross-backend bit-identity all hold per codec (property-tested).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# codec name -> on-disk dtype; "auto" resolves to the narrowest that fits
CODEC_DTYPES: Dict[str, np.dtype] = {
    "i32": np.dtype(np.int32),
    "u16": np.dtype(np.uint16),
    "u8": np.dtype(np.uint8),
}

CODECS = ("auto",) + tuple(CODEC_DTYPES)


def resolve_codec(codec: str, vocab: int) -> str:
    """Validate ``codec`` against ``vocab``; resolve ``auto`` to a width.

    Raises ``ValueError`` for an unknown codec or one too narrow to hold
    every id in ``[0, vocab)`` losslessly — corrupting ids is never an option.
    """
    if codec == "auto":
        if vocab <= 1 << 8:
            return "u8"
        if vocab <= 1 << 16:
            return "u16"
        return "i32"
    if codec not in CODEC_DTYPES:
        raise ValueError(f"unknown spool codec {codec!r}; choose from {CODECS}")
    limit = 1 << (8 * CODEC_DTYPES[codec].itemsize)
    if codec != "i32" and vocab > limit:
        raise ValueError(
            f"spool codec {codec!r} holds ids < {limit}, but vocab={vocab}; "
            "narrow spooling must stay lossless (use 'auto')"
        )
    return codec


def encode_rows(rows: np.ndarray, codec: str) -> np.ndarray:
    """int32 sample rows -> on-disk representation (checked, lossless)."""
    dt = CODEC_DTYPES[codec]
    if dt == rows.dtype:
        return rows
    info = np.iinfo(dt)
    if rows.min() < info.min or rows.max() > info.max:
        raise ValueError(
            f"token ids [{rows.min()}, {rows.max()}] overflow spool codec "
            f"{codec!r} — refusing lossy spool"
        )
    return rows.astype(dt)


def decode_rows(rows: np.ndarray) -> np.ndarray:
    """On-disk representation -> int32 rows (the in-device widen)."""
    return np.asarray(rows, np.int32)


def bytes_per_sample(codec: str, seq_len: int) -> int:
    """On-flash payload bytes for one ``(seq_len+1,)`` sample row."""
    return (seq_len + 1) * CODEC_DTYPES[codec].itemsize
