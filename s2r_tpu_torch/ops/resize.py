"""Bilinear resize with torch ``align_corners=True`` semantics, as matmuls.

The port of s2r_tpu/ops/resize.py: separable 1-D interpolation written as two
dense products, out = M_h @ x @ M_w^T per (batch, channel), in float32 (f64
stays f64), with the interpolation matrices built in float64 by numpy.
Inputs are NCHW.

Under row sharding (ops/halo.py) x and the output are bands of their
global heights (their levels: say 33 -> 129 -> 513 at align-corners): a
rank takes its output band's rows of the global H matrix, gathers the
input rows of their nonzero column window (align-corners windows cross
the bands on either side; the gather's plan is every rank's) and
applies the W matrix as before.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from s2r_tpu_torch.core.mesh import band_bounds
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
def _band_matrix(h_in: int, b_in: int, h_out: int, b_out: int, size: int,
                 rank: int, dtype: torch.dtype, device: torch.device):
    """(windows, M): every rank's window of input rows, the nonzero
    columns of its output band's rows of the global (h_out, h_in) matrix
    (bands of b_in and b_out rows, core/mesh.py ``band_bounds``; an empty
    output band takes an empty window at the input's end), and this
    rank's rows of the matrix over its window."""
    full = _interp_matrix(h_in, h_out)
    windows = []
    for t in range(size):
        o0, o1 = band_bounds(h_out, b_out, t)
        cols = np.nonzero(full[o0:o1].any(axis=0))[0]
        windows.append((int(cols[0]), int(cols[-1]) + 1) if len(cols)
                       else (h_in, h_in))
    o0, o1 = band_bounds(h_out, b_out, rank)
    lo, hi = windows[rank]
    with torch.inference_mode(False):
        return tuple(windows), torch.from_numpy(
            np.ascontiguousarray(full[o0:o1, lo:hi])).to(device, dtype)


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
        h_in, b_in = halo.level(x)
        h_out, b_out = halo.level_of_width(ow, oh)
        windows, m = _band_matrix(h_in, b_in, h_out, b_out, mesh.size,
                                  mesh.rank, compute, x.device)
        lo, hi = windows[mesh.rank]
        xg = halo.gather_rows(x, lo, hi, mesh, 0.0, (h_in, b_in), windows)
        y = torch.matmul(m, xg.to(compute))
    y = torch.matmul(y, _matrix(w, ow, compute, x.device).T)
    return y.to(out_dtype)
