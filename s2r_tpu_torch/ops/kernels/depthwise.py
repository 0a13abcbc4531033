"""3x3 depthwise convolution (stride 1, zero padding = dilation), NHWC,
with its gradient.

The port of the TPU kernel ``s2r_tpu/ops/pallas/depthwise.py``
(``depthwise_conv3x3`` and its VJP).  ``depthwise_conv3x3`` (the forward,
and the VJP's ``dx`` on the flipped taps) and ``depthwise_dk`` (the VJP's
``dk``) launch the hand-written CUDA kernels of
``s2r_tpu_torch/csrc/depthwise.cu`` for CUDA tensors and take the plain
PyTorch versions only for CPU tensors.  There is no fallback: anything the
kernels do not take raises.  ``DepthwiseConv3x3`` is the autograd Function
that ties them together.

The forward kernel indexes in 32 bits, so the wrapper launches it once per
run of whole images of fewer than 2^31 elements (``over_batch``); only a
single image of 2^31 or more elements raises.  dk indexes its pixels in 64
bits where it must and takes any batch in one launch.

MobileNetV2 runs its 14 stride-1 depthwise convs through here
(models/layers.py); the ``fill`` ring of the reference's padding quirk stays
outside, in the Conv2d identity, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from s2r_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "s2r_dw3x3_f32", torch.bfloat16: "s2r_dw3x3_bf16"}
_DK = {torch.float32: "s2r_dw3x3_dk_f32", torch.bfloat16: "s2r_dw3x3_dk_bf16"}


def depthwise_conv3x3_plain(x: torch.Tensor, k: torch.Tensor,
                            dilation: int = 1) -> torch.Tensor:
    """The same function as a grouped F.conv2d in float32 (float64 stays
    float64), cast back to x's dtype: x [N,H,W,C], k [3,3,C] -> [N,H,W,C]."""
    c = x.shape[-1]
    f = torch.promote_types(x.dtype, torch.float32)
    w = k.to(f).permute(2, 0, 1).unsqueeze(1)  # [C,1,3,3]
    y = F.conv2d(x.to(f).permute(0, 3, 1, 2), w, padding=dilation,
                 dilation=dilation, groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def depthwise_dk_plain(x: torch.Tensor, g: torch.Tensor,
                       dilation: int = 1) -> torch.Tensor:
    """The VJP's dk as nine shifted products summed in float32 (the JAX
    package's _dw_bwd; float64 stays float64): x, g [N,H,W,C] -> dk
    [3,3,C]."""
    d = int(dilation)
    h, w = x.shape[1], x.shape[2]
    f = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(f), (0, 0, d, d, d, d))
    g32 = g.to(f)
    return torch.stack([
        torch.stack([(xp[:, dy * d:dy * d + h, dx * d:dx * d + w] * g32)
                     .sum((0, 1, 2)) for dx in range(3)])
        for dy in range(3)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library with its entries' types set, once."""
    lib = build.load("depthwise")
    for name in _DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _DK.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.s2r_dw3x3_dk_max_slabs.restype = ctypes.c_int
    lib.max_slabs = lib.s2r_dw3x3_dk_max_slabs()
    return lib


def _check_cuda(what: str, x: torch.Tensor, other: torch.Tensor) -> None:
    """Raise unless x and other can go to the kernels: one CUDA device, one
    of the kernels' types, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if x.dtype not in _DTYPES or other.dtype != x.dtype:
        raise TypeError(f"{what}: {x.dtype} and {other.dtype} must both be "
                        "float32 or both bfloat16")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: input is not on the current device")


def depthwise_conv3x3(x: torch.Tensor, k: torch.Tensor,
                      dilation: int = 1) -> torch.Tensor:
    """x [N,H,W,C] f32/bf16, k [3,3,C] in x's dtype -> [N,H,W,C] in x's dtype.

    Stride 1, zero padding = dilation, f32 accumulation.  Any C, H, W.
    """
    if x.dim() != 4 or k.shape != (3, 3, x.shape[-1]):
        raise ValueError(f"depthwise_conv3x3: x {tuple(x.shape)} must be "
                         f"[N,H,W,C] and k {tuple(k.shape)} [3,3,C]")
    if int(dilation) < 1:
        raise ValueError(f"depthwise_conv3x3: dilation {dilation} < 1")
    if x.device != k.device:
        raise ValueError("depthwise_conv3x3: x and k on different devices")
    if x.device.type == "cpu":
        return depthwise_conv3x3_plain(x, k, dilation)
    _check_cuda("depthwise_conv3x3", x, k)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    over_batch(x, k, y, int(dilation), _launch_dw3x3)
    return y


depthwise_conv3x3.launches = 0


def over_batch(x: torch.Tensor, k: torch.Tensor, y: torch.Tensor,
               dilation: int, launch, limit: int = build.INDEX_LIMIT) -> None:
    """Fill y from x by launch(x[a:b], k, y[a:b], dilation) over runs of
    whole images of fewer than `limit` elements each (the forward kernel
    indexes in 32 bits; images are independent, so the split changes
    nothing)."""
    if x.numel() < limit:
        launch(x, k, y, dilation)
        return
    for a, b in build.batch_chunks(x.shape[0], x.numel() // x.shape[0],
                                   limit):
        launch(x[a:b], k, y[a:b], dilation)


def _launch_dw3x3(x: torch.Tensor, k: torch.Tensor, y: torch.Tensor,
                  dilation: int) -> None:
    """One launch of the forward kernel on contiguous CUDA x, y."""
    n, h, w, c = x.shape
    fn = getattr(_lib(), _DTYPES[x.dtype])
    err = fn(x.data_ptr(), k.data_ptr(), y.data_ptr(), n, h, w, c, dilation,
             build.stream(x))
    build.check(err, "depthwise_conv3x3")
    depthwise_conv3x3.launches += 1


def depthwise_dk(x: torch.Tensor, g: torch.Tensor,
                 dilation: int = 1) -> torch.Tensor:
    """x, g [N,H,W,C] f32/bf16 of one type -> dk [3,3,C] float32, with
    dk[dy,dx,c] = sum over n,h,w of x[n, h+(dy-1)d, w+(dx-1)d, c] * g[n,h,w,c]
    (zero outside the image)."""
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"depthwise_dk: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be one [N,H,W,C] shape")
    if int(dilation) < 1:
        raise ValueError(f"depthwise_dk: dilation {dilation} < 1")
    if x.device != g.device:
        raise ValueError("depthwise_dk: x and g on different devices")
    if x.device.type == "cpu":
        return depthwise_dk_plain(x, g, dilation)
    _check_cuda("depthwise_dk", x, g)
    n, h, w, c = x.shape
    dk = torch.empty((3, 3, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dk.zero_()
    lib = _lib()
    part = torch.empty((lib.max_slabs * 9 * c,),
                       dtype=torch.float32, device=x.device)
    err = getattr(lib, _DK[x.dtype])(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dk.data_ptr(), n, h, w, c,
        int(dilation), build.stream(x))
    build.check(err, "depthwise_dk")
    depthwise_dk.launches += 1
    return dk


depthwise_dk.launches = 0


class DepthwiseConv3x3(torch.autograd.Function):
    """depthwise_conv3x3 with its VJP (s2r_tpu/ops/pallas/depthwise.py
    _dw_bwd): dx is the same kernel on the cotangent with the taps flipped
    in both spatial axes, dk is depthwise_dk cast to k's type."""

    @staticmethod
    def forward(ctx, x, k, dilation: int):
        ctx.save_for_backward(x, k)
        ctx.dilation = int(dilation)
        return depthwise_conv3x3(x, k, dilation)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        d = ctx.dilation
        g = g.to(x.dtype).contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv3x3(g, k.flip((0, 1)).contiguous(), d)
        if ctx.needs_input_grad[1]:
            dk = depthwise_dk(x, g, d).to(k.dtype)
        return dx, dk, None
