"""Bilinear resize with torch ``align_corners=True`` semantics, as matmuls.

The port of s2r_tpu/ops/resize.py: separable 1-D interpolation written as two
dense products, out = M_h @ x @ M_w^T per (batch, channel), in float32 (f64
stays f64), with the interpolation matrices built in float64 by numpy.
Inputs are NCHW.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) align-corners interpolation matrix in float64.

    Row o weighs the input samples around coordinate o*(in-1)/(out-1);
    out_size == 1 maps to coordinate 0 and in_size == 1 broadcasts.
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    scale = 0.0 if out_size == 1 else (in_size - 1) / (out_size - 1)
    coords = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w = coords - lo
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m


@functools.lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """_interp_matrix as a tensor, kept on the device between calls."""
    return torch.from_numpy(_interp_matrix(in_size, out_size)).to(device, dtype)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw,
                                  dtype: torch.dtype = None) -> torch.Tensor:
    """Resize NCHW `x` to spatial size `out_hw` (h, w), output in `dtype`
    (default x's dtype).  Matches F.interpolate(mode='bilinear',
    align_corners=True) up to float associativity."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out_dtype = x.dtype if dtype is None else dtype
    if (oh, ow) == (h, w):
        return x.to(out_dtype)
    compute = torch.promote_types(x.dtype, torch.float32)
    y = torch.matmul(_matrix(h, oh, compute, x.device), x.to(compute))
    y = torch.matmul(y, _matrix(w, ow, compute, x.device).T)
    return y.to(out_dtype)
