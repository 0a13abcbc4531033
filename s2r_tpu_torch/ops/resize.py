"""Bilinear resize with torch ``align_corners=True`` semantics, as matmuls.

The port of s2r_tpu/ops/resize.py: separable 1-D interpolation written as two
dense products, out = M_h @ x @ M_w^T per (batch, channel), in float32 (f64
stays f64), with the interpolation matrices built in float64 by numpy.
Inputs are NCHW.

Under row sharding (ops/halo.py) x and the output are bands of their
global heights: a rank takes its output rows of the global H matrix,
gathers the input rows in their nonzero column window (align-corners
windows cross the bands on either side; every rank gathers the widest
window's halo, so all gather one shape) and applies the W matrix as
before.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from s2r_tpu_torch.ops import halo


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
    """_interp_matrix as a tensor, kept on the device between calls.  Made
    outside inference mode, so a training step can save it for backward
    after a serving call filled the cache."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(in_size, out_size)).to(
            device, dtype)


@functools.lru_cache(maxsize=64)
def _band_matrix(h: int, oh: int, size: int, rank: int, dtype: torch.dtype,
                 device: torch.device):
    """(above, below, M): the rows of the global (oh*size, h*size) matrix
    that rank `rank`'s output band takes, over its input band extended by
    `above` and `below` rows (the widest window over the ranks; the rows
    outside the image weigh 0)."""
    full = _interp_matrix(h * size, oh * size)
    above = below = 0
    for t in range(size):
        cols = np.nonzero(full[t * oh:(t + 1) * oh].any(axis=0))[0]
        above = max(above, t * h - int(cols[0]))
        below = max(below, int(cols[-1]) + 1 - (t + 1) * h)
    lo = rank * h - above
    m = np.zeros((oh, h + above + below))
    for j in range(m.shape[1]):
        if 0 <= lo + j < h * size:
            m[:, j] = full[rank * oh:(rank + 1) * oh, lo + j]
    with torch.inference_mode(False):
        return above, below, torch.from_numpy(m).to(device, dtype)


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
    mesh = halo.current()
    if mesh is None:
        y = torch.matmul(_matrix(h, oh, compute, x.device), x.to(compute))
    else:
        above, below, m = _band_matrix(h, oh, mesh.size, mesh.rank, compute,
                                       x.device)
        r0 = mesh.rank * h
        xg = halo.gather_rows(x, r0 - above, r0 + h + below, mesh)
        y = torch.matmul(m, xg.to(compute))
    y = torch.matmul(y, _matrix(w, ow, compute, x.device).T)
    return y.to(out_dtype)
