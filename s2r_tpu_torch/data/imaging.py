"""PIL-free image reading and resampling for the host data pipeline.

The JAX package's data path takes these from PIL (s2r_tpu/data/
transforms.py, datasets.py, hostcrop.py); the card's machine has no PIL, so
the port computes the same bytes itself:

- ``load_rgb(path)`` is ``Image.open(path).convert("RGB")`` and
  ``load_raw(path)`` is ``np.asarray(Image.open(path), np.uint8)``: palette
  indices of a P-mode label, the values of an L-mode one, [H, W, 4] of an
  RGBA one.  The file is read, inflated (zlib) and unfiltered in C++
  (``csrc/host/png.h``, shared with the native pipeline), which releases
  the GIL, so the loader's threads decode in parallel.  Adam7 files decode
  at every depth and color type; 16-bit files decode where Pillow gives
  their high bytes (RGB and RGBA, and gray+alpha to RGB), and the other
  16-bit cases raise (ROADMAP A.4).
- ``resize_bilinear`` (with ``box=``), ``resize_nearest`` and
  ``gaussian_blur`` give Pillow's BILINEAR, NEAREST and GaussianBlur
  results bit for bit; ``flip_lr``, ``expand`` and ``crop`` its transpose,
  ImageOps.expand on the right and bottom, and crop.

Arrays are uint8 [H, W] or [H, W, C] and sizes are PIL's (width, height).
The C++ library is built with g++ at first use (ops/kernels/build.py); a
failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

from s2r_tpu_torch.ops.kernels import build

_UNSUPPORTED = "is not supported by the port's decoder (ROADMAP A.4)"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("imaging")
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
        ctypes.c_float
    lib.s2r_png_header.argtypes = [p, i64, p]
    lib.s2r_png_read.argtypes = [p, i64, i32, p, i64]
    lib.s2r_resize_bilinear.argtypes = [p, i64, i64, i64, p, i64, i64,
                                        f32, f32, f32, f32]
    lib.s2r_gaussian_blur.argtypes = [p, i64, i64, i64, f32, p]
    for fn in (lib.s2r_png_header, lib.s2r_png_read,
               lib.s2r_resize_bilinear, lib.s2r_gaussian_blur):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise ValueError(f"{what} failed (code {err})")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ------------------------------------------------------------------ PNG ---

# The error codes of csrc/host/png.h.
PNG_ERRORS = {1: f"a color type or bit depth that {_UNSUPPORTED}",
              2: "an image stream of the wrong length",
              3: "an unknown filter type",
              4: "not a PNG file",
              5: "a broken PNG chunk (past the end, or a bad CRC)",
              6: "a PNG without IHDR or IDAT",
              7: "an image stream zlib cannot inflate",
              8: "cannot be read",
              9: "too large to decode in memory"}
RAW, RGB = 0, 1  # png.h's modes


def png_error(name: str, code: int) -> ValueError:
    return ValueError(f"{name}: {PNG_ERRORS.get(code, f'error {code}')}")


def _pil_bytes(depth: int, color: int, rgb: bool) -> bool:
    """Whether Pillow gives the high bytes of a 16-bit file (mode RGB or
    RGBA from "RGB;16B", "RGBA;16B", and gray+alpha converted to RGB); it
    gives 16-bit gray as "I;16" and gray+alpha as RGBA, which the decoder
    does not reproduce."""
    return depth != 16 or color in (2, 6) or (color == 4 and rgb)


def decode_png(data: bytes, rgb: bool, name: str = "<png>") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] with `rgb`, else the file's own samples
    ([H, W] for gray and palette files, [H, W, C] otherwise)."""
    src = np.frombuffer(data, np.uint8)
    hdr = np.zeros(5, np.int64)
    err = _lib().s2r_png_header(_ptr(src), src.size, _ptr(hdr))
    if err:
        raise png_error(name, err)
    w, h, depth, color, _ = (int(v) for v in hdr)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None or not _pil_bytes(depth, color, rgb):
        raise ValueError(f"{name}: a {depth}-bit PNG of color type {color} "
                         f"{_UNSUPPORTED}{'' if rgb else ' as raw samples'}")
    shape = (h, w, 3) if rgb else ((h, w) if channels == 1
                                   else (h, w, channels))
    out = np.empty(shape, np.uint8)
    err = _lib().s2r_png_read(_ptr(src), src.size, RGB if rgb else RAW,
                              _ptr(out), out.size)
    if err:
        raise png_error(name, err)
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def load_rgb(path: str) -> np.ndarray:
    """``Image.open(path).convert("RGB")`` as uint8 [H, W, 3]."""
    return decode_png(_read(path), True, path)


def load_raw(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path), np.uint8)``: the samples as stored
    (palette indices stay indices; 1-bit gray is 0/1)."""
    return decode_png(_read(path), False, path)


# ------------------------------------------------------------ resampling ---

def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each of `n_out` positions in PIL's NEAREST
    resize from `n_in`: PIL starts at scale / 2 and adds scale = n_in /
    n_out once a position, in double precision, truncating each
    (Geometry.c ImagingScaleAffine).  A closed form (i + 0.5) * scale
    rounds differently at some sizes (512 -> 640 among them)."""
    steps = np.full(n_out, n_in / n_out, np.float64)
    steps[0] *= 0.5
    return np.minimum(np.add.accumulate(steps).astype(np.int64), n_in - 1)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, Image.NEAREST)``; size is (width, height)."""
    w, h = size
    if img.shape[1] == w and img.shape[0] == h:
        return img.copy()
    return img[nearest_index(img.shape[0], h)][
        :, nearest_index(img.shape[1], w)]


def resize_bilinear(img: np.ndarray, size: Tuple[int, int],
                    box: Optional[Sequence[float]] = None) -> np.ndarray:
    """``Image.resize(size, Image.BILINEAR, box)``: size is (width, height),
    box the source window (x0, y0, x1, y1) in pixels."""
    w, h = int(size[0]), int(size[1])
    ih, iw = img.shape[:2]
    if box is None:
        box = (0, 0, iw, ih)
    if (iw, ih) == (w, h) and tuple(box) == (0, 0, iw, ih):
        return img.copy()
    if w < 1 or h < 1:
        raise ValueError("height and width must be > 0")
    x0, y0, x1, y1 = (np.float32(v) for v in box)  # Pillow parses floats
    if x0 < 0 or y0 < 0:
        raise ValueError("box offset can't be negative")
    if x1 > iw or y1 > ih:
        raise ValueError("box can't exceed original image size")
    if x1 - x0 < 0 or y1 - y0 < 0:
        raise ValueError("box can't be empty")
    if (x0 - int(x0) == 0 and x1 - x0 == w and y0 - int(y0) == 0
            and y1 - y0 == h):  # an integer box of the output's size
        return crop(img, (int(x0), int(y0), int(x1), int(y1)))
    src = np.ascontiguousarray(img)
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    c = img.shape[2] if img.ndim == 3 else 1
    _check(_lib().s2r_resize_bilinear(_ptr(src), ih, iw, c, _ptr(out), h, w,
                                      x0, y0, x1, y1), "resize_bilinear")
    return out


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``img.filter(ImageFilter.GaussianBlur(radius))``."""
    if radius == 0:
        return img.copy()
    src = np.ascontiguousarray(img)
    out = np.empty_like(src)
    c = img.shape[2] if img.ndim == 3 else 1
    _check(_lib().s2r_gaussian_blur(_ptr(src), img.shape[0], img.shape[1], c,
                                    radius, _ptr(out)), "gaussian_blur")
    return out


# ------------------------------------------------------------- geometry ---

def flip_lr(img: np.ndarray) -> np.ndarray:
    """``transpose(Image.FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(img[:, ::-1])


def expand(img: np.ndarray, padw: int, padh: int, fill: int) -> np.ndarray:
    """``ImageOps.expand(img, border=(0, 0, padw, padh), fill=fill)``: pad
    on the right and at the bottom."""
    h, w = img.shape[:2]
    out = np.full((h + padh, w + padw) + img.shape[2:], fill, np.uint8)
    out[:h, :w] = img
    return out


def crop(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """``img.crop(box)`` for a box inside the image."""
    x0, y0, x1, y1 = box
    return np.ascontiguousarray(img[y0:y1, x0:x1])
