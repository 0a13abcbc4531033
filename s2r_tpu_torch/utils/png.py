"""A minimal PNG encoder on the standard library's zlib (8-bit RGB,
grayscale or palette), so the port writes images without PIL.

``filters`` gives the filter type of each row in turn (0 None, 1 Sub, 2 Up,
3 Average, 4 Paeth), so a writer can exercise every filter a decoder has to
undo; the exports use None on every row.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, filters: Sequence[int]
                ) -> np.ndarray:
    """uint8 scanlines [H, N] -> [H, 1 + N], each row filtered with
    filters[y % len(filters)] (PNG spec 9.2) behind its filter-type byte."""
    if not any(filters):  # None on every row: the bytes as they are
        out = np.zeros((rows.shape[0], rows.shape[1] + 1), np.uint8)
        out[:, 1:] = rows
        return out
    x = rows.astype(np.int16)
    prev = np.zeros_like(x)
    prev[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = prev[:, :-bpp]
    types = np.resize(np.asarray(filters, np.uint8), x.shape[0])
    pred = np.zeros_like(x)
    for f in set(types.tolist()) - {0}:
        sel = types == f
        a, b = left[sel], prev[sel]
        if f == 1:
            pred[sel] = a
        elif f == 2:
            pred[sel] = b
        elif f == 3:
            pred[sel] = (a + b) >> 1
        else:
            pred[sel] = _paeth(a, b, upleft[sel])
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = types
    out[:, 1:] = (x - pred) & 0xFF
    return out


def encode_png(image: np.ndarray, palette: Optional[np.ndarray] = None,
               filters: Sequence[int] = (0,), level: int = 6) -> bytes:
    """uint8 [H, W, 3] (RGB), [H, W] (gray, or palette indices when
    `palette`, [K, 3] uint8, is given) -> PNG bytes."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 2:
        color = 0 if palette is None else 3
    elif img.ndim == 3 and img.shape[2] == 3 and palette is None:
        color = 2
    else:
        raise ValueError(f"encode_png: shape {img.shape}")
    h, w = img.shape[:2]
    bpp = 3 if color == 2 else 1
    raw = filter_rows(img.reshape(h, -1), bpp, filters)
    plte = b"" if palette is None else _chunk(
        b"PLTE", np.ascontiguousarray(palette, np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + plte
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, **kw))
