"""Train-mode BatchNorm: per-channel pair sums and the autograd Function.

The port of the TPU kernel ``s2r_tpu/ops/pallas/batchnorm.py``.
``pair_sums(a, b)`` launches the hand-written CUDA kernel
``s2r_tpu_torch/csrc/batchnorm.cu`` for CUDA tensors and takes the plain
PyTorch version ``pair_sums_plain`` only for CPU tensors; there is no
fallback.  ``BatchNormTrain`` runs both directions of every train-mode
BatchNorm through it: the forward statistics are ``pair_sums(x, x)`` and
the backward sums ``pair_sums(g, x)``.

Unlike the JAX package's Pallas composite, which drops the cotangents of
the batch statistics and so runs only without the padding ring, the
Function also returns ``shift`` (what a zero ring around the input becomes
after normalization, s2r_tpu/models/layers.py:330-336) and folds its
cotangent into the backward: every MobileNetV2 expand BN feeds ``shift``
to the depthwise conv's ``fill``, so the loss depends on the batch mean
and variance through it.

Layout: the sums read a channels-last ``[M, C]`` matrix.  The model's
activations are channels-last already (a view, no copy); a tensor in
another layout, such as a cotangent that autograd hands back NCHW, is
copied to channels-last first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from s2r_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "s2r_pair_sums_f32",
           torch.bfloat16: "s2r_pair_sums_bf16"}


def pair_sums_plain(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in float32 PyTorch (float64 stays float64): a, b
    [..., C] -> (sum a, sum a*b) over every leading dim, each [C]."""
    f = torch.promote_types(a.dtype, torch.float32)
    a32 = a.reshape(-1, a.shape[-1]).to(f)
    b32 = b.reshape(-1, b.shape[-1]).to(f)
    return a32.sum(0), (a32 * b32).sum(0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library with its entries' types set, once."""
    lib = build.load("batchnorm")
    for name in _DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.s2r_pair_sums_max_slabs.restype = ctypes.c_int
    lib.max_slabs = lib.s2r_pair_sums_max_slabs()
    return lib


def pair_sums(a: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b [..., C] of one shape and type (f32 or bf16), C fastest ->
    (sum a, sum a*b) per channel over every leading dim, float32 [C].
    Pass the same tensor twice for (sum x, sum x^2): it is read once."""
    if a.shape != b.shape or a.dim() < 1:
        raise ValueError(f"pair_sums: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one [..., C] shape")
    if a.device != b.device:
        raise ValueError("pair_sums: a and b on different devices")
    if a.device.type == "cpu":
        return pair_sums_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pair_sums: no kernel for {a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"pair_sums: a {a.dtype} and b {b.dtype} must both "
                        "be float32 or both bfloat16")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pair_sums: a and b must be contiguous")
    if a.device.index != torch.cuda.current_device():
        raise ValueError("pair_sums: a is not on the current device")
    c = a.shape[-1]
    m = a.numel() // c if c else 0
    out = torch.empty((2, c), dtype=torch.float32, device=a.device)
    if a.numel() == 0:
        return out.zero_()[0], out[1]
    lib = _lib()
    part = torch.empty((2 * lib.max_slabs * c,),
                       dtype=torch.float32, device=a.device)
    err = getattr(lib, _DTYPES[a.dtype])(
        a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), m, c,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "pair_sums")
    pair_sums.launches += 1
    return out[0], out[1]


pair_sums.launches = 0


def _rows(x: torch.Tensor) -> torch.Tensor:
    """NCHW x -> its channels-last [N*H*W, C] matrix: a view when x is
    channels-last in memory, else a channels-last copy."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1]).contiguous()


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm with torch statistics rules, NCHW.

    forward(x, weight, bias, eps, pad) -> (y, shift, mean, var): statistics
    over N*(H+2*pad)*(W+2*pad) positions, i.e. as if x were zero-padded by
    `pad` (the sums are unchanged, the count grows); var is biased; inv =
    rsqrt(var + eps) * weight and shift = bias - mean * inv in float32, y =
    x * inv + shift in x's type.  mean and var are returned for the running
    statistics and carry no gradient.

    With G = sum(g) + d(shift), the backward is dbias = G, dweight =
    rstd * (sum(g*x) - mean * G) and dx = inv * (g - G/n - rstd^2 * (x -
    mean) * (sum(g*x) - mean * G)/n): the JAX Pallas backward
    (batchnorm.py:138-153) with sum(g) widened by the cotangent of shift.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, pad: int):
        n, c, h, w = x.shape
        rows = _rows(x)
        sx, sxx = pair_sums(rows, rows)
        count = n * (h + 2 * pad) * (w + 2 * pad)
        mean = sx / count
        var = sxx / count - mean * mean
        rstd = torch.rsqrt(var + eps)
        inv = rstd * weight
        shift = bias - mean * inv
        y = x * _col(inv.to(x.dtype)) + _col(shift.to(x.dtype))
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y, shift, mean, var

    @staticmethod
    def backward(ctx, gy, gshift, _gmean, _gvar):
        x, weight, mean, rstd = ctx.saved_tensors
        n = ctx.count
        sg, sgx = pair_sums(_rows(gy.to(x.dtype)), _rows(x))
        big_g = sg + gshift
        t = sgx - mean * big_g
        inv = rstd * weight
        dx = None
        if ctx.needs_input_grad[0]:
            b = -inv * rstd * rstd * t / n
            c0 = -inv * big_g / n - b * mean
            f = inv.dtype
            dx = (gy.to(f) * _col(inv) + x.to(f) * _col(b)
                  + _col(c0)).to(x.dtype)
        dweight = rstd * t if ctx.needs_input_grad[1] else None
        dbias = big_g if ctx.needs_input_grad[2] else None
        return dx, dweight, dbias, None, None
