"""The native host pipeline (``--data-backend native``): the port's
counterpart of s2r_tpu/native/__init__.py over ``csrc/host/pipeline.cpp``.

One C call decodes, flips, scale-crops, blurs and normalizes or remaps a
whole batch on a std::thread pool, with the JAX package's signatures,
output dtypes and layouts:

- ``decode_png(path_or_bytes, channels)`` -> uint8 [H, W, 3] or [H, W]
- ``resize_bilinear(img_u8, (h, w))``, ``resize_nearest(img_u8, (h, w))``
- ``remap(labels_u8, lut)``, ``normalize(img_u8, mean, std)`` -> float32
- ``eval_batch(...)`` -> (images float32 [N, crop, crop, 3], labels int32
  [N, crop, crop], 255 where an item has no label)
- ``train_batch(...)`` -> (src, lbl, tgt or None): float32 NHWC images and
  int32 labels, or uint8 both under ``emit_u8``

PNGs decode without libpng (``csrc/host/png.h``, shared with the PIL
route's data/imaging.py), and a palette label gives its indices, as PIL
reads it (the JAX library gives the luma of the palette colours: ROADMAP
C.12).  The library builds with g++ at first use (ops/kernels/build.py);
a failed build raises, and so does a file that is missing or does not
decode, named in the error.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from s2r_tpu_torch.data.imaging import png_error
from s2r_tpu_torch.ops.kernels import build

_WHICH = ("image", "label", "target")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("pipeline")
    p, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.s2r_png_info.argtypes = [p, size, p, p]
    lib.s2r_png_decode.argtypes = [p, size, i32, p, p, p]
    lib.s2r_resize_bilinear_u8.argtypes = [p, i32, i32, i32, p, i32, i32]
    lib.s2r_resize_nearest_u8.argtypes = lib.s2r_resize_bilinear_u8.argtypes
    lib.s2r_remap_u8.argtypes = [p, p, size, p]
    lib.s2r_remap_u8.restype = None
    lib.s2r_normalize_f32.argtypes = [p, size, p, p, p]
    lib.s2r_normalize_f32.restype = None
    strs = ctypes.POINTER(ctypes.c_char_p)
    lib.s2r_eval_batch.argtypes = [strs, strs, i32, i32, p, p, p, p, p, i32,
                                   p]
    lib.s2r_train_batch.argtypes = [strs, strs, strs, i32, i32, i32, i32, p,
                                    p, p, p, i32, p, i32, p, p, p, i32, p]
    for fn in (lib.s2r_png_info, lib.s2r_png_decode,
               lib.s2r_resize_bilinear_u8, lib.s2r_resize_nearest_u8,
               lib.s2r_eval_batch, lib.s2r_train_batch):
        fn.restype = ctypes.c_int
    return lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data


def _f32(v) -> np.ndarray:
    return np.ascontiguousarray(v, np.float32)


def _paths(paths: Sequence[Optional[str]], n: int):
    if len(paths) != n:
        raise ValueError(f"{len(paths)} paths for a batch of {n}")
    return (ctypes.c_char_p * n)(*[os.fsencode(p or "") for p in paths])


def _lut(lut) -> np.ndarray:
    """The label LUT, 256 uint8, checked before the C side reads it."""
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.shape != (256,):
        raise ValueError(f"a label LUT holds 256 entries, not {lut.shape}")
    return lut


def _stats(mean, std) -> Tuple[np.ndarray, np.ndarray]:
    """The per-channel mean and std, 3 float32 each."""
    mean, std = _f32(mean), _f32(std)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"mean {mean.shape} and std {std.shape}: 3 each")
    return mean, std


def decode_png(data, channels: int = 3) -> np.ndarray:
    """A PNG (a path or its bytes) -> uint8 [H, W, 3] (channels 3) or
    [H, W] (channels 1: gray, the luma of RGB, or palette indices)."""
    name = "<png>"
    if isinstance(data, (str, os.PathLike)):
        name = os.fspath(data)
        with open(data, "rb") as f:
            data = f.read()
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    err = _lib().s2r_png_info(_ptr(buf), buf.size, ctypes.byref(w),
                              ctypes.byref(h))
    if err:
        raise png_error(name, err)
    out = np.empty((h.value, w.value, channels), np.uint8)
    err = _lib().s2r_png_decode(_ptr(buf), buf.size, channels, _ptr(out),
                                ctypes.byref(w), ctypes.byref(h))
    if err:
        raise png_error(name, err)
    return out[..., 0] if channels == 1 else out


def _resize(fn, img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    ch = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((size[0], size[1], ch), np.uint8)
    fn(_ptr(img), img.shape[1], img.shape[0], ch, _ptr(out), size[1], size[0])
    return out[..., 0] if img.ndim == 2 else out


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W(, C)] -> [h, w(, C)], size = (h, w): the JAX pipeline's
    own fixed-point triangle filter."""
    return _resize(_lib().s2r_resize_bilinear_u8, img, size)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W(, C)] -> [h, w(, C)]: index floor((i + 0.5) * scale)."""
    return _resize(_lib().s2r_resize_nearest_u8, img, size)


def remap(labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
    labels = np.ascontiguousarray(labels, np.uint8)
    lut = _lut(lut)
    out = np.empty_like(labels)
    _lib().s2r_remap_u8(_ptr(labels), _ptr(out), labels.size, _ptr(lut))
    return out


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 RGB [..., 3] -> float32 x * (1 / (255 std)) + (-mean / std)."""
    img = np.ascontiguousarray(img, np.uint8)
    mean, std = _stats(mean, std)
    if img.shape[-1:] != (3,):
        raise ValueError(f"normalize takes [..., 3] RGB, not {img.shape}")
    out = np.empty(img.shape, np.float32)
    _lib().s2r_normalize_f32(_ptr(img), img.size // 3, _ptr(mean), _ptr(std),
                             _ptr(out))
    return out


def _raise_failed(what: str, item: int, fail: np.ndarray,
                  paths: Sequence[Sequence[Optional[str]]]):
    i = item - 1
    path = paths[int(fail[0])][i]
    raise png_error(f"native {what}: item {i}, {_WHICH[int(fail[0])]} {path}",
                    int(fail[1]))


def eval_batch(img_paths: Sequence[str], lbl_paths: Optional[Sequence[str]],
               crop: int, lut: np.ndarray, mean, std, threads: int = 8):
    """The eval pipeline of a batch (FixedResize to crop x crop, normalize,
    NEAREST + LUT remap) in one C call: (images float32 [N, crop, crop, 3],
    labels int32 [N, crop, crop], 255 where an item has no label)."""
    n = len(img_paths)
    images = np.empty((n, crop, crop, 3), np.float32)
    labels = np.full((n, crop, crop), 255, np.int32)
    lbls = [None] * n if lbl_paths is None else list(lbl_paths)
    lut, (mean, std) = _lut(lut), _stats(mean, std)
    fail = np.zeros(2, np.int32)
    rc = _lib().s2r_eval_batch(_paths(img_paths, n), _paths(lbls, n), n, crop,
                               _ptr(lut), _ptr(mean), _ptr(std),
                               _ptr(images), _ptr(labels), threads,
                               _ptr(fail))
    if rc:
        _raise_failed("eval_batch", rc, fail, (img_paths, lbls))
    return images, labels


def train_batch(src_paths: Sequence[str], lbl_paths: Sequence[str],
                tgt_paths: Optional[Sequence[str]], base_size: int,
                crop_size, lut: np.ndarray, mean, std,
                seeds: Optional[Sequence[int]] = None, blur: bool = True,
                forced: Optional[np.ndarray] = None, emit_u8: bool = False,
                threads: int = 8):
    """The paired train path of a batch (decode, joint flip,
    RandomScaleCrop, blur, normalize / remap) in one C call.

    crop_size: an int (square) or (h, w).  seeds: each sample's uint64
    augmentation seed (default 0..n-1).  forced: [n, 4] int32 (flip,
    short_size, x1, y1) pinning the geometric draws (blur off).  emit_u8:
    skip the host normalization; images and labels come back uint8.
    Returns (src [n, h, w, 3], lbl [n, h, w], tgt [n, h, w, 3] or None)."""
    n = len(src_paths)
    ch, cw = (crop_size, crop_size) if isinstance(crop_size, int) \
        else (int(crop_size[0]), int(crop_size[1]))
    img_dt = np.uint8 if emit_u8 else np.float32
    src = np.empty((n, ch, cw, 3), img_dt)
    lbl = np.empty((n, ch, cw), np.uint8 if emit_u8 else np.int32)
    tgt = None if tgt_paths is None else np.empty((n, ch, cw, 3), img_dt)
    lut, (mean, std) = _lut(lut), _stats(mean, std)
    seeds = np.ascontiguousarray(
        np.arange(n, dtype=np.uint64) if seeds is None else seeds, np.uint64)
    if forced is not None:
        forced = np.ascontiguousarray(forced, np.int32)
    if seeds.shape != (n,) or (forced is not None and forced.shape != (n, 4)):
        raise ValueError(f"seeds {seeds.shape}, forced "
                         f"{None if forced is None else forced.shape} for a "
                         f"batch of {n}: expected ({n},), ({n}, 4)")
    fail = np.zeros(2, np.int32)
    rc = _lib().s2r_train_batch(
        _paths(src_paths, n), _paths(lbl_paths, n),
        None if tgt_paths is None else _paths(tgt_paths, n), n, base_size, ch,
        cw, _ptr(lut), _ptr(mean), _ptr(std), _ptr(seeds), int(blur),
        _ptr(forced), int(emit_u8), _ptr(src), _ptr(lbl), _ptr(tgt), threads,
        _ptr(fail))
    if rc:
        _raise_failed("train_batch", rc, fail,
                      (src_paths, lbl_paths, tgt_paths))
    return src, lbl, tgt
