"""Stride-2 convolutions through space-to-depth (s2r_tpu/ops/s2d.py), NCHW
and OIHW.

A 4x4 stride-2 padding-1 convolution equals a 3x3 stride-1 padding-1
convolution over the space-to-depth(2) input, and a 3x3 stride-2
padding-1 one a 2x2 stride-1 convolution padded (1, 0) on each spatial
axis; the kernels are scattered into their s2d forms, parameters keep
their shapes.  The JAX package offers the forms for the TPU's lane
layout (its measurements stay in its module); on the card they are
``F.conv2d`` on the rearranged input, as the JAX package computes them
with ``lax.conv_general_dilated`` outside any Pallas kernel.  Exact up to
the order of the float sums.

Derivation (4x4): with padding 1, output row h reads input rows 2h-1 ..
2h+2.  Under s2d(2) (input row 2r+a is s2d row r, sub-row a in {0, 1})
those are s2d rows h-1 .. h+1: a 3-tap kernel in s2d space whose tap dr
at sub-row a is the original tap i = 2*dr - 1 + a when 0 <= i < 4, else
zero.  The s2d padding row r = -1 holds input rows -2 and -1, of which
only -1 (a = 1) has a nonzero weight: exactly the zero padding row.  The
3x3 form is the same with taps i = 2*dr + a - 1 for dr in {0, 1}; the
bottom and right padding rows are never read for even H and W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor, b: int = 2) -> torch.Tensor:
    """[N, C, H, W] -> [N, b*b*C, H/b, W/b]; the channel index is (a, b, c)
    (the JAX package's order: sub-row, sub-column, channel)."""
    n, c, h, w = x.shape
    if h % b or w % b:
        raise ValueError(f"space_to_depth: {h}x{w} is not a multiple of {b}")
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, b * b * c, h // b, w // b)


def _scatter(k: torch.Tensor, taps: int, tap_of) -> torch.Tensor:
    """[O, C, K, K] -> [O, 4C, taps, taps]: s2d tap (dr, dc) at sub-pixel
    (a, b) holds k[..., tap_of(dr, a), tap_of(dc, b)], or zero where that
    is outside the kernel."""
    o, c, kh, kw = k.shape
    out = k.new_zeros((o, 2, 2, c, taps, taps))
    for dr in range(taps):
        for a in range(2):
            i = tap_of(dr, a)
            if not 0 <= i < kh:
                continue
            for dc in range(taps):
                for b in range(2):
                    j = tap_of(dc, b)
                    if 0 <= j < kw:
                        out[:, a, b, :, dr, dc] = k[:, :, i, j]
    return out.reshape(o, 4 * c, taps, taps)


def s2d_kernel_4x4s2(k: torch.Tensor) -> torch.Tensor:
    """Scatter a [O, C, 4, 4] kernel into its [O, 4C, 3, 3] s2d(2) form."""
    if tuple(k.shape[2:]) != (4, 4):
        raise ValueError(f"s2d_kernel_4x4s2: kernel {tuple(k.shape)}")
    return _scatter(k, 3, lambda d, a: 2 * d - 1 + a)


def s2d_kernel_3x3s2(k: torch.Tensor) -> torch.Tensor:
    """Scatter a [O, C, 3, 3] kernel into its [O, 4C, 2, 2] s2d(2) form."""
    if tuple(k.shape[2:]) != (3, 3):
        raise ValueError(f"s2d_kernel_3x3s2: kernel {tuple(k.shape)}")
    return _scatter(k, 2, lambda d, a: 2 * d + a - 1)


def conv3x3s2_via_s2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """F.conv2d(x, kernel, stride=2, padding=1) for a 3x3 kernel on even H
    and W, as a 2x2 stride-1 conv over s2d(x) padded by one row and column
    at the top and left only."""
    return F.conv2d(F.pad(space_to_depth(x), (1, 0, 1, 0)),
                    s2d_kernel_3x3s2(kernel))


def conv4x4s2_via_s2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """F.conv2d(x, kernel, stride=2, padding=1) for a 4x4 kernel on even H
    and W, as a 3x3 stride-1 padding-1 conv over s2d(x)."""
    return F.conv2d(space_to_depth(x), s2d_kernel_4x4s2(kernel), padding=1)
