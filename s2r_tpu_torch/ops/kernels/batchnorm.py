"""Train-mode BatchNorm as hand-written kernels, both directions.

The port of the TPU kernel ``s2r_tpu/ops/pallas/batchnorm.py``
(``pair_sums`` and the composite ``batch_norm_train`` around it).  Four
entries, each launching the hand-written CUDA kernels of
``s2r_tpu_torch/csrc/batchnorm.cu`` for CUDA tensors and taking its plain
PyTorch version (``*_plain``) only for CPU tensors; there is no fallback:

- ``batch_norm_stats(x, weight, bias, count, eps, ...)``: the per-channel
  sums of x and x^2 and, from them, mean, var, rstd, inv = rstd * weight
  and shift = bias - mean * inv, with the running statistics updated in
  place (one launch on small inputs: slab sums whose last blocks fold the
  slabs and run the per-channel epilogue; two on large ones, the fold a
  kernel of its own);
- ``batch_norm_apply(x, inv, shift)``: y = x * inv + shift (one launch);
- ``batch_norm_grad_sums(g, x, stats, gshift, count)``: the sums of g and
  g*x and, from them, dweight, dbias and the dx coefficients b and c0 (as
  the statistics);
- ``batch_norm_dx(g, x, inv, b, c0)``: dx = g * inv + x * b + c0 (one
  launch).

The per-channel results come back as rows of one float32 ``[rows, C]``
tensor (``STAT_ROWS``, ``GRAD_ROWS`` name them); on the card it is the head
of the one workspace a call allocates, whose tail holds the slab partials.
``BatchNormTrain`` is the autograd Function over them.  The kernels share
arrival counters across calls, so calls run one at a time on one stream,
as the port's do.

Unlike the JAX package's Pallas composite, which drops the cotangents of
the batch statistics and so runs only without the padding ring, the
Function also returns ``shift`` (what a zero ring around the input becomes
after normalization, s2r_tpu/models/layers.py:330-336) and folds its
cotangent into the backward: every MobileNetV2 expand BN feeds ``shift``
to the depthwise conv's ``fill``, so the loss depends on the batch mean
and variance through it.

Layout: the kernels read and write a channels-last ``[M, C]`` matrix.  The
model's activations are channels-last already (a view, no copy); a tensor
in another layout, such as a cotangent that autograd hands back NCHW, is
copied to channels-last first, and y and dx are copied back to x's layout
when it is not channels-last; ``channels_last_rows.copies`` counts those
copies.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from s2r_tpu_torch.ops.kernels import build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Rows of the per-channel results (csrc/batchnorm.cu StatRow, GradRow).
SUM_X, SUM_XX, MEAN, VAR, RSTD, INV, SHIFT = range(7)
STAT_ROWS = 7
SUM_G, SUM_GX, DWEIGHT, DBIAS, COEF_B, COEF_C0 = range(6)
GRAD_ROWS = 6


def pair_sums_plain(a: torch.Tensor, b: torch.Tensor):
    """(sum a, sum a*b) per channel over every leading dim of a, b [..., C],
    in float32 (float64 stays float64)."""
    f = torch.promote_types(a.dtype, torch.float32)
    a32 = a.reshape(-1, a.shape[-1]).to(f)
    b32 = b.reshape(-1, b.shape[-1]).to(f)
    return a32.sum(0), (a32 * b32).sum(0)


def batch_norm_stats_plain(x, weight, bias, count: int, eps: float,
                           running_mean=None, running_var=None,
                           momentum: float = 0.1) -> torch.Tensor:
    """batch_norm_stats in PyTorch: [STAT_ROWS, C]."""
    sx, sxx = pair_sums_plain(x, x)
    mean = sx / count
    var = sxx / count - mean * mean
    rstd = torch.rsqrt(var + eps)
    inv = rstd * weight
    shift = bias - mean * inv
    if running_mean is not None:
        unbiased = var * (count / max(count - 1, 1))
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * unbiased)
    return torch.stack([sx, sxx, mean, var, rstd, inv, shift])


def batch_norm_apply_plain(x, inv, shift) -> torch.Tensor:
    """batch_norm_apply in PyTorch: float32 math (float64 stays float64),
    the result in x's type."""
    f = torch.promote_types(x.dtype, torch.float32)
    return (x.to(f) * inv + shift).to(x.dtype)


def batch_norm_grad_sums_plain(g, x, stats, gshift, count: int
                               ) -> torch.Tensor:
    """batch_norm_grad_sums in PyTorch: [GRAD_ROWS, C]."""
    sg, sgx = pair_sums_plain(g, x)
    mean, rstd, inv = stats[MEAN], stats[RSTD], stats[INV]
    big_g = sg if gshift is None else sg + gshift
    t = sgx - mean * big_g
    b = -inv * rstd * rstd * t / count
    c0 = -inv * big_g / count - b * mean
    return torch.stack([sg, sgx, rstd * t, big_g, b, c0])


def batch_norm_dx_plain(g, x, inv, b, c0) -> torch.Tensor:
    """batch_norm_dx in PyTorch: float32 math (float64 stays float64), the
    result in x's type."""
    f = torch.promote_types(x.dtype, torch.float32)
    return (g.to(f) * inv + x.to(f) * b + c0).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library with its entries' types set, once."""
    lib = build.load("batchnorm")
    if (lib.s2r_bn_stat_rows(), lib.s2r_bn_grad_rows()) != (STAT_ROWS,
                                                            GRAD_ROWS):
        raise RuntimeError("batchnorm: the library's row layout is not the "
                           "wrapper's")
    p, i64, dbl = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.s2r_bn_slabs.argtypes = [p, p, i64, i64, i64]
    lib.s2r_bn_slabs.restype = i64
    for sfx in _SUFFIX.values():
        for name, args in (
                ("stats", [p] * 6 + [i64, i64, dbl, dbl, dbl, p]),
                ("apply", [p] * 4 + [i64, i64, p]),
                ("grad_sums", [p] * 5 + [i64, i64, dbl, p]),
                ("dx", [p] * 6 + [i64, i64, p])):
            fn = getattr(lib, f"s2r_bn_{name}_{sfx}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _check_rows(what: str, *mats: torch.Tensor) -> None:
    """Raise unless every [M, C] matrix can go to the kernels: CUDA on the
    current device, one type of the kernels', one shape, contiguous."""
    x = mats[0]
    if x.dim() != 2 or any(m.shape != x.shape for m in mats):
        raise ValueError(f"{what}: inputs {[tuple(m.shape) for m in mats]} "
                         "must be one [M, C] shape")
    if any(m.device != x.device for m in mats):
        raise ValueError(f"{what}: inputs on different devices")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if x.dtype not in _SUFFIX or any(m.dtype != x.dtype for m in mats):
        raise TypeError(f"{what}: inputs {[m.dtype for m in mats]} must all "
                        "be float32 or all bfloat16")
    if not all(m.is_contiguous() for m in mats):
        raise ValueError(f"{what}: inputs must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: input is not on the current device")


def _check_vectors(what: str, x: torch.Tensor, *vecs) -> None:
    """Raise unless each per-channel vector is float32 [C], contiguous, on
    x's device (None passes)."""
    for v in vecs:
        if v is None:
            continue
        if (v.dtype != torch.float32 or v.shape != (x.shape[-1],)
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{what}: per-channel inputs must be contiguous "
                             f"float32 [{x.shape[-1]}] on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _workspace(lib, a, b, rows: int) -> torch.Tensor:
    """One float32 buffer [rows + 2 * slabs, C]: the per-channel results,
    then the slab partials of the sums over a, b."""
    m, c = a.shape
    slabs = lib.s2r_bn_slabs(a.data_ptr(), b.data_ptr(), m, c,
                             a.element_size())
    return torch.empty((rows + 2 * slabs, c), dtype=torch.float32,
                       device=a.device)


def batch_norm_stats(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, count: int, eps: float,
                     running_mean: Optional[torch.Tensor] = None,
                     running_var: Optional[torch.Tensor] = None,
                     momentum: float = 0.1) -> torch.Tensor:
    """x [M, C] (f32/bf16, channels fastest), weight and bias float32 [C]
    -> float32 [STAT_ROWS, C]: sum x, sum x^2, mean = sum x / count, var =
    sum x^2 / count - mean^2 (biased), rstd = rsqrt(var + eps), inv = rstd *
    weight, shift = bias - mean * inv.  `count` may exceed M (the zero
    ring: the sums are unchanged).  running_mean and running_var, if given,
    become (1 - momentum) * old + momentum * (mean, var * count / (count -
    1)), in place."""
    if (running_mean is None) != (running_var is None):
        raise ValueError("batch_norm_stats: give both running statistics "
                         "or neither")
    if x.device.type == "cpu":
        return batch_norm_stats_plain(x, weight, bias, count, eps,
                                      running_mean, running_var, momentum)
    _check_rows("batch_norm_stats", x)
    _check_vectors("batch_norm_stats", x, weight, bias, running_mean,
                   running_var)
    m, c = x.shape
    if m == 0:
        raise ValueError("batch_norm_stats: no rows")
    lib = _lib()
    ws = _workspace(lib, x, x, STAT_ROWS)
    err = getattr(lib, f"s2r_bn_stats_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if running_mean is None else running_mean.data_ptr(),
        None if running_var is None else running_var.data_ptr(),
        ws.data_ptr(), m, c, float(count), float(eps), float(momentum),
        build.stream(x))
    build.check(err, "batch_norm_stats")
    batch_norm_stats.launches += 1
    return ws[:STAT_ROWS]


batch_norm_stats.launches = 0


def batch_norm_apply(x: torch.Tensor, inv: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """x [M, C] f32/bf16, inv and shift float32 [C] -> y = x * inv + shift,
    [M, C] in x's type, the math in float32."""
    if x.device.type == "cpu":
        return batch_norm_apply_plain(x, inv, shift)
    _check_rows("batch_norm_apply", x)
    _check_vectors("batch_norm_apply", x, inv, shift)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = getattr(_lib(), f"s2r_bn_apply_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), inv.data_ptr(), shift.data_ptr(), y.data_ptr(),
        *x.shape, build.stream(x))
    build.check(err, "batch_norm_apply")
    batch_norm_apply.launches += 1
    return y


batch_norm_apply.launches = 0


def batch_norm_grad_sums(g: torch.Tensor, x: torch.Tensor,
                         stats: torch.Tensor, gshift: Optional[torch.Tensor],
                         count: int) -> torch.Tensor:
    """g, x [M, C] of one type, stats batch_norm_stats' result, gshift the
    cotangent of shift (float32 [C] or None) -> float32 [GRAD_ROWS, C]:
    sum g, sum g*x, dweight = rstd * t, dbias = G, and the dx coefficients
    b = -inv * rstd^2 * t / count and c0 = -inv * G / count - b * mean,
    where G = sum g + gshift and t = sum g*x - mean * G."""
    if g.shape != x.shape:
        raise ValueError(f"batch_norm_grad_sums: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} must be one [M, C] shape")
    if x.device.type == "cpu":
        return batch_norm_grad_sums_plain(g, x, stats, gshift, count)
    _check_rows("batch_norm_grad_sums", g, x)
    c = x.shape[1]
    if (stats.dtype != torch.float32 or stats.shape != (STAT_ROWS, c)
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError("batch_norm_grad_sums: stats must be "
                         "batch_norm_stats' result for x")
    _check_vectors("batch_norm_grad_sums", x, gshift)
    if x.shape[0] == 0:
        raise ValueError("batch_norm_grad_sums: no rows")
    lib = _lib()
    ws = _workspace(lib, g, x, GRAD_ROWS)
    err = getattr(lib, f"s2r_bn_grad_sums_{_SUFFIX[x.dtype]}")(
        g.data_ptr(), x.data_ptr(), stats.data_ptr(),
        None if gshift is None else gshift.data_ptr(), ws.data_ptr(),
        *x.shape, float(count), build.stream(x))
    build.check(err, "batch_norm_grad_sums")
    batch_norm_grad_sums.launches += 1
    return ws[:GRAD_ROWS]


batch_norm_grad_sums.launches = 0


def batch_norm_dx(g: torch.Tensor, x: torch.Tensor, inv: torch.Tensor,
                  b: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """g, x [M, C] of one type, inv, b, c0 float32 [C] -> dx = g * inv + x
    * b + c0, [M, C] in x's type, the math in float32."""
    if g.shape != x.shape:
        raise ValueError(f"batch_norm_dx: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} must be one [M, C] shape")
    if x.device.type == "cpu":
        return batch_norm_dx_plain(g, x, inv, b, c0)
    _check_rows("batch_norm_dx", g, x)
    _check_vectors("batch_norm_dx", x, inv, b, c0)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    err = getattr(_lib(), f"s2r_bn_dx_{_SUFFIX[x.dtype]}")(
        g.data_ptr(), x.data_ptr(), inv.data_ptr(), b.data_ptr(),
        c0.data_ptr(), dx.data_ptr(), *x.shape, build.stream(x))
    build.check(err, "batch_norm_dx")
    batch_norm_dx.launches += 1
    return dx


batch_norm_dx.launches = 0


def channels_last_rows(x: torch.Tensor) -> torch.Tensor:
    """NCHW x -> its channels-last [N*H*W, C] matrix: a view when x is
    channels-last in memory, else a channels-last copy (counted)."""
    nhwc = x.permute(0, 2, 3, 1)
    if not nhwc.is_contiguous():
        channels_last_rows.copies += 1
        nhwc = nhwc.contiguous()
    return nhwc.view(-1, x.shape[1])


channels_last_rows.copies = 0


def _nchw(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N*H*W, C] rows -> NCHW in like's memory format: the view when like
    is channels-last, else a copy in like's layout (counted)."""
    n, c, h, w = like.shape
    out = rows.view(n, h, w, c).permute(0, 3, 1, 2)
    if like.permute(0, 2, 3, 1).is_contiguous():
        return out
    channels_last_rows.copies += 1
    return torch.empty_like(like, device=rows.device).copy_(out)


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm with torch statistics rules, NCHW.

    forward(x, weight, bias, eps, pad, running_mean=None, running_var=None,
    momentum=0.1) -> (y, shift, mean, var): statistics over
    N*(H+2*pad)*(W+2*pad) positions, i.e. as if x were zero-padded by
    `pad` (the sums are unchanged, the count grows); var is biased; inv =
    rsqrt(var + eps) * weight and shift = bias - mean * inv in float32, y =
    x * inv + shift in x's type and memory format.  The running
    statistics, if given, are updated in place over the same count.  mean
    and var carry no gradient.

    With G = sum(g) + d(shift), the backward is dbias = G, dweight =
    rstd * (sum(g*x) - mean * G) and dx = inv * (g - G/n - rstd^2 * (x -
    mean) * (sum(g*x) - mean * G)/n) = g * inv + x * b + c0: the JAX Pallas
    backward (batchnorm.py:138-153) with sum(g) widened by the cotangent of
    shift.  Each direction is two kernel entries (batch_norm_stats and
    batch_norm_apply; batch_norm_grad_sums and batch_norm_dx).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, pad: int,
                running_mean=None, running_var=None, momentum: float = 0.1):
        n, _, h, w = x.shape
        rows = channels_last_rows(x)
        count = n * (h + 2 * pad) * (w + 2 * pad)
        stats = batch_norm_stats(rows, weight, bias, count, eps,
                                 running_mean, running_var, momentum)
        y = _nchw(batch_norm_apply(rows, stats[INV], stats[SHIFT]), x)
        ctx.save_for_backward(rows, stats)
        ctx.count = count
        # x's shape and memory format, for dx (a meta tensor holds no data)
        ctx.x_like = torch.empty_like(x, device="meta")
        mean, var = stats[MEAN], stats[VAR]
        ctx.mark_non_differentiable(mean, var)
        return y, stats[SHIFT], mean, var

    @staticmethod
    def backward(ctx, gy, gshift, _gmean, _gvar):
        rows, stats = ctx.saved_tensors
        g = channels_last_rows(gy.to(rows.dtype))
        grads = batch_norm_grad_sums(g, rows, stats, gshift, ctx.count)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = batch_norm_dx(g, rows, stats[INV], grads[COEF_B],
                               grads[COEF_C0])
            dx = _nchw(dx, ctx.x_like)
        dweight = grads[DWEIGHT] if ctx.needs_input_grad[1] else None
        dbias = grads[DBIAS] if ctx.needs_input_grad[2] else None
        return dx, dweight, dbias, None, None, None, None, None
