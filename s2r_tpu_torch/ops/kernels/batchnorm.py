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

The wrappers' host path is lean, since most of a step's BatchNorms are
small enough that it, not the card, sets their pace: each typed C entry is
bound once (``_lib``), the slab count is cached by what the library
computes it from (``_slabs``), and the checks read tensor attributes
without building views.

Synchronized BatchNorm (data-parallel training, one process per card)
splits each direction's statistics at the all-reduce of its two sums, and
the caller reduces rows 0-1 of the result between the two calls:

- ``batch_norm_sums(x)``: rows SUM_X, SUM_XX (the sums' launches of
  batch_norm_stats, the epilogue cut to those rows);
  ``batch_norm_finish_apply(x, stats, weight, bias, count, eps, ...)``:
  y = x * inv + shift from the reduced sums over the global count, with
  the rest of the rows filled in place and the running statistics updated
  (one launch: every block computes its channels' inv and shift as the
  fused epilogue does, so a forward is two launches and one all-reduce);
- ``batch_norm_grad_sums_local(g, x, stats, gshift)``: rows SUM_G = sum g
  + gshift (this rank's cotangent of shift, added before the reduction),
  SUM_GX, and this rank's shares of DWEIGHT and DBIAS (summed over ranks
  with the other gradients, they are the global batch's);
  ``batch_norm_grad_finish(grads, stats, count)``: COEF_B and COEF_C0 from
  the reduced sums (one launch).

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


def batch_norm_sums_plain(x) -> torch.Tensor:
    """batch_norm_sums in PyTorch: [STAT_ROWS, C], rows SUM_X and SUM_XX
    set, the others zero."""
    sx, sxx = pair_sums_plain(x, x)
    out = sx.new_zeros((STAT_ROWS, sx.shape[0]))
    out[SUM_X], out[SUM_XX] = sx, sxx
    return out


def batch_norm_finish_plain(stats, weight, bias, count: int, eps: float,
                            running_mean=None, running_var=None,
                            momentum: float = 0.1) -> torch.Tensor:
    """The per-channel half of batch_norm_finish_apply_plain (and of
    batch_norm_stats_plain): [STAT_ROWS, C] from rows SUM_X and SUM_XX of
    `stats` (a new tensor), the running statistics updated in place."""
    sx, sxx = stats[SUM_X], stats[SUM_XX]
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


def batch_norm_stats_plain(x, weight, bias, count: int, eps: float,
                           running_mean=None, running_var=None,
                           momentum: float = 0.1) -> torch.Tensor:
    """batch_norm_stats in PyTorch: [STAT_ROWS, C]."""
    return batch_norm_finish_plain(batch_norm_sums_plain(x), weight, bias,
                                   count, eps, running_mean, running_var,
                                   momentum)


def batch_norm_apply_plain(x, inv, shift) -> torch.Tensor:
    """batch_norm_apply in PyTorch: float32 math (float64 stays float64),
    the result in x's type."""
    f = torch.promote_types(x.dtype, torch.float32)
    return (x.to(f) * inv + shift).to(x.dtype)


def batch_norm_finish_apply_plain(x, stats, weight, bias, count: int,
                                  eps: float, running_mean=None,
                                  running_var=None, momentum: float = 0.1
                                  ) -> torch.Tensor:
    """batch_norm_finish_apply in PyTorch: rows MEAN..SHIFT of `stats`
    filled in place from its rows SUM_X and SUM_XX, the running statistics
    updated, and y = x * inv + shift returned."""
    stats.copy_(batch_norm_finish_plain(stats, weight, bias, count, eps,
                                        running_mean, running_var, momentum))
    return batch_norm_apply_plain(x, stats[INV], stats[SHIFT])


def _grad_coefs(big_g, sgx, stats, count: int):
    """(dweight, b, c0) of the backward from G and sum g*x."""
    mean, rstd, inv = stats[MEAN], stats[RSTD], stats[INV]
    t = sgx - mean * big_g
    b = -inv * rstd * rstd * t / count
    c0 = -inv * big_g / count - b * mean
    return rstd * t, b, c0


def batch_norm_grad_sums_plain(g, x, stats, gshift, count: int
                               ) -> torch.Tensor:
    """batch_norm_grad_sums in PyTorch: [GRAD_ROWS, C]."""
    sg, sgx = pair_sums_plain(g, x)
    big_g = sg if gshift is None else sg + gshift
    dweight, b, c0 = _grad_coefs(big_g, sgx, stats, count)
    return torch.stack([sg, sgx, dweight, big_g, b, c0])


def batch_norm_grad_sums_local_plain(g, x, stats, gshift) -> torch.Tensor:
    """batch_norm_grad_sums_local in PyTorch: [GRAD_ROWS, C], rows SUM_G
    (gshift included), SUM_GX, DWEIGHT and DBIAS set, the others zero."""
    sg, sgx = pair_sums_plain(g, x)
    big_g = sg if gshift is None else sg + gshift
    mean, rstd = stats[MEAN], stats[RSTD]
    zero = torch.zeros_like(sg)
    return torch.stack([big_g, sgx, rstd * (sgx - mean * big_g), big_g,
                        zero, zero])


def batch_norm_grad_finish_plain(grads, stats, count: int) -> torch.Tensor:
    """batch_norm_grad_finish in PyTorch: `grads` with COEF_B and COEF_C0
    from rows SUM_G and SUM_GX (a new tensor)."""
    _, b, c0 = _grad_coefs(grads[SUM_G], grads[SUM_GX], stats, count)
    return torch.cat([grads[:COEF_B], b[None], c0[None]])


def batch_norm_dx_plain(g, x, inv, b, c0) -> torch.Tensor:
    """batch_norm_dx in PyTorch: float32 math (float64 stays float64), the
    result in x's type."""
    f = torch.promote_types(x.dtype, torch.float32)
    return (g.to(f) * inv + x.to(f) * b + c0).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> dict:
    """The kernels' C entries, loaded and typed once: {(entry, dtype):
    function}, dtype None for the untyped ones (slabs, grad_finish)."""
    lib = build.load("batchnorm")
    if (lib.s2r_bn_stat_rows(), lib.s2r_bn_grad_rows()) != (STAT_ROWS,
                                                            GRAD_ROWS):
        raise RuntimeError("batchnorm: the library's row layout is not the "
                           "wrapper's")
    p, i, i64, dbl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_double)
    typed = {"stats": [p] * 6 + [i64, i64, dbl, dbl, dbl, p],
             "stats_sums": [p] * 2 + [i64, i64, p],
             "finish_apply": [p] * 7 + [i64, i64, dbl, dbl, dbl, p],
             "apply": [p] * 4 + [i64, i64, p],
             "grad_sums": [p] * 5 + [i64, i64, dbl, p],
             "grad_sums_local": [p] * 5 + [i64, i64, p],
             "dx": [p] * 6 + [i64, i64, p]}

    def bind(fn, args, res=i):
        fn.argtypes, fn.restype = args, res
        return fn

    fns = {(name, dtype): bind(getattr(lib, f"s2r_bn_{name}_{sfx}"), args)
           for name, args in typed.items() for dtype, sfx in _SUFFIX.items()}
    fns["grad_finish", None] = bind(lib.s2r_bn_grad_finish,
                                    [p] * 2 + [i64, dbl, p])
    fns["slabs", None] = bind(lib.s2r_bn_slabs, [i, i64, i64, i64], i64)
    return fns


@functools.lru_cache(maxsize=4096)
def _slabs(m: int, c: int, itemsize: int, aligned: bool) -> int:
    """Slabs of the sums over [m, c] inputs: what s2r_bn_slabs reads (the
    shape, the element size, and whether both inputs are 16-byte aligned),
    asked of the library once a key."""
    return _lib()["slabs", None](int(aligned), m, c, itemsize)


def _workspace(ap: int, bp: int, like: torch.Tensor, rows: int
               ) -> torch.Tensor:
    """One float32 buffer [rows + 2 * slabs, C]: the per-channel results,
    then the slab partials of the sums over the inputs at ap, bp (like's
    shape and type)."""
    m, c = like.shape
    slabs = _slabs(m, c, like.element_size(), not (ap | bp) & 15)
    return torch.empty((rows + 2 * slabs, c), dtype=torch.float32,
                       device=like.device)


def _plain_device(what: str, t: torch.Tensor) -> None:
    """Raise unless t, which is not on the card, is on the CPU: the only
    device the plain versions serve."""
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for {t.device}")


def _check_rows(what: str, x: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> int:
    """Raise unless x (and g) [M, C] can go to the kernels: CUDA on the
    current device, one type of the kernels', one shape, contiguous; the
    device's index."""
    if x.dim() != 2 or (g is not None and g.shape != x.shape):
        shapes = [tuple(t.shape) for t in (x, g) if t is not None]
        raise ValueError(f"{what}: inputs {shapes} must be one [M, C] shape")
    dev = x.get_device()
    if g is not None and g.get_device() != dev:
        raise ValueError(f"{what}: inputs on different devices")
    if not x.is_cuda:
        raise ValueError(f"{what}: no kernel for {x.device}")
    if x.dtype not in _SUFFIX or (g is not None and g.dtype != x.dtype):
        types = [t.dtype for t in (x, g) if t is not None]
        raise TypeError(f"{what}: inputs {types} must all be float32 or all "
                        "bfloat16")
    if not x.is_contiguous() or (g is not None and not g.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if dev != torch.cuda.current_device():
        raise ValueError(f"{what}: input is not on the current device")
    return dev


def _check_vectors(what: str, c: int, dev: int, *vecs) -> None:
    """Raise unless each per-channel vector is float32 [c], contiguous, on
    card `dev` (None passes)."""
    for v in vecs:
        if v is None:
            continue
        if (v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != c
                or v.get_device() != dev or not v.is_contiguous()):
            raise ValueError(f"{what}: per-channel inputs must be contiguous "
                             f"float32 [{c}] on cuda:{dev}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def _check_head(what: str, head: torch.Tensor, rows: int, c: int,
                dev: int) -> None:
    """Raise unless `head` is a contiguous float32 [rows, c] tensor on card
    `dev`: per-channel rows of the entries (statistics, backward sums)."""
    if (head.dtype != torch.float32 or head.dim() != 2
            or head.shape[0] != rows or head.shape[1] != c
            or head.get_device() != dev or not head.is_contiguous()):
        raise ValueError(f"{what}: want the contiguous float32 [{rows}, {c}] "
                         f"rows of the entries on cuda:{dev}, got "
                         f"{head.dtype} {tuple(head.shape)} on {head.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
    what = "batch_norm_stats"
    if (running_mean is None) != (running_var is None):
        raise ValueError(f"{what}: give both running statistics or neither")
    if not x.is_cuda:
        _plain_device(what, x)
        return batch_norm_stats_plain(x, weight, bias, count, eps,
                                      running_mean, running_var, momentum)
    dev = _check_rows(what, x)
    m, c = x.shape
    _check_vectors(what, c, dev, weight, bias, running_mean, running_var)
    if m == 0:
        raise ValueError(f"{what}: no rows")
    xp = x.data_ptr()
    ws = _workspace(xp, xp, x, STAT_ROWS)
    err = _lib()["stats", x.dtype](
        xp, weight.data_ptr(), bias.data_ptr(), _ptr(running_mean),
        _ptr(running_var), ws.data_ptr(), m, c, float(count), float(eps),
        float(momentum), build.stream(x))
    build.check(err, what)
    batch_norm_stats.launches += 1
    return ws[:STAT_ROWS]


batch_norm_stats.launches = 0


def batch_norm_apply(x: torch.Tensor, inv: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """x [M, C] f32/bf16, inv and shift float32 [C] -> y = x * inv + shift,
    [M, C] in x's type, the math in float32."""
    what = "batch_norm_apply"
    if not x.is_cuda:
        _plain_device(what, x)
        return batch_norm_apply_plain(x, inv, shift)
    dev = _check_rows(what, x)
    _check_vectors(what, x.shape[1], dev, inv, shift)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = _lib()["apply", x.dtype](x.data_ptr(), inv.data_ptr(),
                                   shift.data_ptr(), y.data_ptr(), *x.shape,
                                   build.stream(x))
    build.check(err, what)
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
    what = "batch_norm_grad_sums"
    if g.shape != x.shape:
        raise ValueError(f"{what}: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} must be one [M, C] shape")
    if not x.is_cuda:
        _plain_device(what, x)
        return batch_norm_grad_sums_plain(g, x, stats, gshift, count)
    dev = _check_rows(what, g, x)
    m, c = x.shape
    _check_head(what, stats, STAT_ROWS, c, dev)
    _check_vectors(what, c, dev, gshift)
    if m == 0:
        raise ValueError(f"{what}: no rows")
    gp, xp = g.data_ptr(), x.data_ptr()
    ws = _workspace(gp, xp, x, GRAD_ROWS)
    err = _lib()["grad_sums", x.dtype](
        gp, xp, stats.data_ptr(), _ptr(gshift), ws.data_ptr(), m, c,
        float(count), build.stream(x))
    build.check(err, what)
    batch_norm_grad_sums.launches += 1
    return ws[:GRAD_ROWS]


batch_norm_grad_sums.launches = 0


def batch_norm_dx(g: torch.Tensor, x: torch.Tensor, inv: torch.Tensor,
                  b: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """g, x [M, C] of one type, inv, b, c0 float32 [C] -> dx = g * inv + x
    * b + c0, [M, C] in x's type, the math in float32."""
    what = "batch_norm_dx"
    if g.shape != x.shape:
        raise ValueError(f"{what}: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} must be one [M, C] shape")
    if not x.is_cuda:
        _plain_device(what, x)
        return batch_norm_dx_plain(g, x, inv, b, c0)
    dev = _check_rows(what, g, x)
    _check_vectors(what, x.shape[1], dev, inv, b, c0)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    err = _lib()["dx", x.dtype](g.data_ptr(), x.data_ptr(), inv.data_ptr(),
                                b.data_ptr(), c0.data_ptr(), dx.data_ptr(),
                                *x.shape, build.stream(x))
    build.check(err, what)
    batch_norm_dx.launches += 1
    return dx


batch_norm_dx.launches = 0


def batch_norm_sums(x: torch.Tensor) -> torch.Tensor:
    """x [M, C] (f32/bf16) -> float32 [STAT_ROWS, C] with rows SUM_X = sum x
    and SUM_XX = sum x^2 (batch_norm_finish_apply fills the other rows):
    the first half of batch_norm_stats, for a reduction of rows 0-1 over
    ranks in between."""
    what = "batch_norm_sums"
    if not x.is_cuda:
        _plain_device(what, x)
        return batch_norm_sums_plain(x)
    _check_rows(what, x)
    m, c = x.shape
    if m == 0:  # no rows (an empty band, a rank of padding): zero sums
        return torch.zeros((STAT_ROWS, c), dtype=torch.float32,
                           device=x.device)
    xp = x.data_ptr()
    ws = _workspace(xp, xp, x, STAT_ROWS)
    err = _lib()["stats_sums", x.dtype](xp, ws.data_ptr(), m, c,
                                        build.stream(x))
    build.check(err, what)
    batch_norm_sums.launches += 1
    return ws[:STAT_ROWS]


batch_norm_sums.launches = 0


def batch_norm_finish_apply(x: torch.Tensor, stats: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            count: int, eps: float,
                            running_mean: Optional[torch.Tensor] = None,
                            running_var: Optional[torch.Tensor] = None,
                            momentum: float = 0.1) -> torch.Tensor:
    """x [M, C] (f32/bf16) and batch_norm_sums' rows of it, SUM_X and
    SUM_XX reduced over ranks -> y = x * inv + shift in x's type, with
    inv and shift what batch_norm_stats gives over `count` positions
    (every rank's).  Rows MEAN..SHIFT of `stats` are filled in place and
    the running statistics updated as batch_norm_stats updates them.  On
    no rows (an empty band) the launch finishes the statistics alone,
    one thread a channel, so every rank holds the same ones."""
    what = "batch_norm_finish_apply"
    if (running_mean is None) != (running_var is None):
        raise ValueError(f"{what}: give both running statistics or neither")
    if not x.is_cuda:
        _plain_device(what, x)
        return batch_norm_finish_apply_plain(x, stats, weight, bias, count,
                                             eps, running_mean, running_var,
                                             momentum)
    dev = _check_rows(what, x)
    m, c = x.shape
    _check_head(what, stats, STAT_ROWS, c, dev)
    _check_vectors(what, c, dev, weight, bias, running_mean, running_var)
    y = torch.empty_like(x)
    err = _lib()["finish_apply", x.dtype](
        x.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        _ptr(running_mean), _ptr(running_var), y.data_ptr(), m, c,
        float(count), float(eps), float(momentum), build.stream(x))
    build.check(err, what)
    batch_norm_finish_apply.launches += 1
    return y


batch_norm_finish_apply.launches = 0


def batch_norm_grad_sums_local(g: torch.Tensor, x: torch.Tensor,
                               stats: torch.Tensor,
                               gshift: Optional[torch.Tensor]
                               ) -> torch.Tensor:
    """g, x [M, C] of one type, stats the finished statistics, gshift this
    rank's cotangent of shift (float32 [C] or None) -> float32 [GRAD_ROWS,
    C] with rows SUM_G = sum g + gshift, SUM_GX = sum g*x, and this rank's
    shares DWEIGHT = rstd * (SUM_GX - mean * SUM_G) and DBIAS = SUM_G (the
    coefficient rows are batch_norm_grad_finish's).  On no rows the sums
    are zero and those rows are gshift's alone, with no launch."""
    what = "batch_norm_grad_sums_local"
    if g.shape != x.shape:
        raise ValueError(f"{what}: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} must be one [M, C] shape")
    if not x.is_cuda:
        _plain_device(what, x)
        return batch_norm_grad_sums_local_plain(g, x, stats, gshift)
    dev = _check_rows(what, g, x)
    m, c = x.shape
    _check_head(what, stats, STAT_ROWS, c, dev)
    _check_vectors(what, c, dev, gshift)
    if m == 0:
        out = torch.zeros((GRAD_ROWS, c), dtype=torch.float32,
                          device=x.device)
        if gshift is not None:
            out[SUM_G] = out[DBIAS] = gshift
            out[DWEIGHT] = stats[RSTD] * (out[SUM_GX] - stats[MEAN] * gshift)
        return out
    gp, xp = g.data_ptr(), x.data_ptr()
    ws = _workspace(gp, xp, x, GRAD_ROWS)
    err = _lib()["grad_sums_local", x.dtype](
        gp, xp, stats.data_ptr(), _ptr(gshift), ws.data_ptr(), m, c,
        build.stream(x))
    build.check(err, what)
    batch_norm_grad_sums_local.launches += 1
    return ws[:GRAD_ROWS]


batch_norm_grad_sums_local.launches = 0


def batch_norm_grad_finish(grads: torch.Tensor, stats: torch.Tensor,
                           count: int) -> torch.Tensor:
    """batch_norm_grad_sums_local's rows (SUM_G and SUM_GX reduced over
    ranks) -> with COEF_B and COEF_C0 over `count` positions (every
    rank's); in place on the card, a new tensor on the CPU."""
    what = "batch_norm_grad_finish"
    if not grads.is_cuda:
        _plain_device(what, grads)
        return batch_norm_grad_finish_plain(grads, stats, count)
    if grads.dim() != 2:
        raise ValueError(f"{what}: grads must be [GRAD_ROWS, C]")
    c, dev = grads.shape[1], grads.get_device()
    _check_head(what, grads, GRAD_ROWS, c, dev)
    _check_head(what, stats, STAT_ROWS, c, dev)
    err = _lib()["grad_finish", None](stats.data_ptr(), grads.data_ptr(), c,
                                      float(count), build.stream(grads))
    build.check(err, what)
    batch_norm_grad_finish.launches += 1
    return grads


batch_norm_grad_finish.launches = 0


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
    momentum=0.1, sync=None) -> (y, shift, mean, var): statistics over
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

    `sync` (core/mesh.py Mesh, of more than one process) synchronizes the
    statistics over the ranks' batches, the JAX package's BatchNorm under
    a sharded batch and the reference's SynchronizedBatchNorm: the sums
    are all-reduced (float32, SUM) between batch_norm_sums and
    batch_norm_finish_apply (which writes y), and between
    batch_norm_grad_sums_local and batch_norm_grad_finish; the count is
    every rank's (below), so the running statistics come out equal on
    every rank.  dweight and dbias are this
    rank's shares, which the step sums over ranks with the other
    gradients.

    `real` (masked batch padding, models/layers.py ``bn_real_batch``):
    only the first `real` samples are real.  The statistics, the running
    update and the backward sums are theirs, over real*(H+2*pad)*(W+2*pad)
    positions: the kernels run on the real prefix of the rows (N is
    outermost in both memory formats, so the prefix is contiguous).  The
    padding samples take the affine only, y = x * inv + shift, and their
    dx is g * inv (the JAX package's masked BatchNorm,
    s2r_tpu/models/layers.py:300-349; every loss masks them, so g is zero
    there).  Under `sync` a rank's `real` may be 0 (its sums are then
    zero), and `samples` gives the real samples over the ranks.

    `bands` and `height` (row sharding, ops/halo.py): x is a band of
    each sample's image of `height` rows (None: bands * h), its other
    rows on the other ranks of the band's group (`bands` of them), and
    `sync` the world they belong to (sync.size / bands data rows).  The
    ring is the global image's, so the count is samples * (height +
    2*pad) * (w + 2*pad): each band has the image's left and right ring,
    the top and bottom ring once (the rows past the last band are no
    one's, so a short or empty band changes nothing).  `samples`, the
    real samples over the data rows, defaults to k * sync.size / bands
    (k without sync): every rank's batch as real as this one's.

    `stats_in` (a recompute under remat, models/layers.py ``remat``): the
    statistics this call's forward computed on the same x, a copy of the
    [STAT_ROWS, C] rows; no statistics are taken, the running statistics
    are not updated and nothing is all-reduced, so a recompute launches
    batch_norm_apply alone.  `stats_out`, a list, receives such a copy of
    this call's statistics.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, pad: int,
                running_mean=None, running_var=None, momentum: float = 0.1,
                sync=None, real: Optional[int] = None, stats_in=None,
                stats_out=None, bands: int = 1,
                height: Optional[int] = None,
                samples: Optional[int] = None):
        n, _, h, w = x.shape
        rows = channels_last_rows(x)
        k = n if real is None else int(real)
        if not (0 < k <= n or (k == 0 and sync is not None)):
            raise ValueError(f"BatchNormTrain: {k} real samples of {n}")
        m = k * h * w
        if bands > 1 and (sync is None or sync.size % bands):
            raise ValueError(f"BatchNormTrain: rows sharded over {bands} "
                             f"ranks need a synchronizing world of a "
                             f"multiple of {bands}")
        if samples is None:
            if k < n and sync is not None:
                raise ValueError("BatchNormTrain: a padded batch under "
                                 "synchronized BatchNorm needs the real "
                                 "samples over the ranks (samples)")
            samples = k if sync is None else k * (sync.size // bands)
        height = bands * h if height is None else int(height)
        count = int(samples) * (height + 2 * pad) * (w + 2 * pad)
        y = None
        if stats_in is not None:
            stats = stats_in.clone()  # outputs are views of it
        elif sync is None:
            stats = batch_norm_stats(rows[:m], weight, bias, count, eps,
                                     running_mean, running_var, momentum)
        else:
            stats = batch_norm_sums(rows[:m])
            sync.all_reduce_(stats[:SUM_XX + 1])
            y = batch_norm_finish_apply(rows, stats, weight, bias, count, eps,
                                        running_mean, running_var, momentum)
        if stats_out is not None:
            stats_out.append(stats.detach().clone())
        if y is None:
            y = batch_norm_apply(rows, stats[INV], stats[SHIFT])
        y = _nchw(y, x)
        ctx.save_for_backward(rows, stats)
        ctx.count = count
        ctx.sync = sync
        ctx.m = m
        # x's shape and memory format, for dx (a meta tensor holds no data)
        ctx.x_like = torch.empty_like(x, device="meta")
        mean, var = stats[MEAN], stats[VAR]
        ctx.mark_non_differentiable(mean, var)
        return y, stats[SHIFT], mean, var

    @staticmethod
    def backward(ctx, gy, gshift, _gmean, _gvar):
        rows, stats = ctx.saved_tensors
        g = channels_last_rows(gy.to(rows.dtype))
        m = ctx.m
        if ctx.sync is None:
            grads = batch_norm_grad_sums(g[:m], rows[:m], stats, gshift,
                                         ctx.count)
        else:
            grads = batch_norm_grad_sums_local(g[:m], rows[:m], stats,
                                               gshift)
            ctx.sync.all_reduce_(grads[:SUM_GX + 1])
            grads = batch_norm_grad_finish(grads, stats, ctx.count)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = batch_norm_dx(g[:m], rows[:m], stats[INV], grads[COEF_B],
                               grads[COEF_C0])
            if m < rows.shape[0]:  # the padding samples: the affine's dx
                f = torch.promote_types(g.dtype, torch.float32)
                dx = torch.cat([dx, (g[m:].to(f) * stats[INV]).to(g.dtype)])
            dx = _nchw(dx, ctx.x_like)
        dweight = grads[DWEIGHT] if ctx.needs_input_grad[1] else None
        dbias = grads[DBIAS] if ctx.needs_input_grad[2] else None
        return (dx, dweight, dbias) + (None,) * 12
