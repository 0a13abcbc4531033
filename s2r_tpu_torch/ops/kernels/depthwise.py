"""3x3 depthwise convolution (stride 1, zero padding = dilation), NHWC.

The port of the TPU kernel ``s2r_tpu/ops/pallas/depthwise.py``
(``depthwise_conv3x3``), forward only: the backward pass comes with the
training path.  ``depthwise_conv3x3`` launches the hand-written CUDA kernel
``s2r_tpu_torch/csrc/depthwise.cu`` for a CUDA tensor and takes the plain
PyTorch version ``depthwise_conv3x3_plain`` only for a CPU tensor.  There is
no fallback: anything the kernel does not take raises.

MobileNetV2 runs its 14 stride-1 depthwise convs through here
(models/layers.py); the ``fill`` ring of the reference's padding quirk stays
outside, in the Conv2d identity, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from s2r_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "s2r_dw3x3_f32", torch.bfloat16: "s2r_dw3x3_bf16"}


def depthwise_conv3x3_plain(x: torch.Tensor, k: torch.Tensor,
                            dilation: int = 1) -> torch.Tensor:
    """The same function as a grouped F.conv2d in float32, cast back to
    x's dtype: x [N,H,W,C], k [3,3,C] -> [N,H,W,C]."""
    c = x.shape[-1]
    w = k.float().permute(2, 0, 1).unsqueeze(1)  # [C,1,3,3]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=dilation,
                 dilation=dilation, groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _lib() -> ctypes.CDLL:
    lib = build.load("depthwise")
    for name in _DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv3x3: no kernel for {x.device}")
    if x.dtype not in _DTYPES or k.dtype != x.dtype:
        raise TypeError(f"depthwise_conv3x3: x {x.dtype} and k {k.dtype} must "
                        "both be float32 or both bfloat16")
    if not (x.is_contiguous() and k.is_contiguous()):
        raise ValueError("depthwise_conv3x3: x and k must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("depthwise_conv3x3: x is not on the current device")
    if x.numel() >= 2 ** 31:
        raise ValueError("depthwise_conv3x3: the kernel indexes in 32 bits; "
                         f"split the batch ({x.numel()} elements)")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    n, h, w, c = x.shape
    fn = getattr(_lib(), _DTYPES[x.dtype])
    err = fn(x.data_ptr(), k.data_ptr(), y.data_ptr(), n, h, w, c,
             int(dilation), torch.cuda.current_stream().cuda_stream)
    build.check(err, "depthwise_conv3x3")
    depthwise_conv3x3.launches += 1
    return y


depthwise_conv3x3.launches = 0
