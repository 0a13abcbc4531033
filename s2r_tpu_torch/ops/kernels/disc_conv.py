"""The discriminator's first conv (4x4, stride 2, padding 1, plus bias) on
the softmax map's W-minor layout, with its gradient.

The port of the TPU kernel ``s2r_tpu/ops/pallas/disc_conv.py``
(``disc_conv1``).  The public function keeps the JAX package's layouts: x
is ``[N, H, C, W]`` (here a view of the NCHW softmax map, read through its
strides, so no relayout happens), the kernel HWIO ``[4, 4, C, ndf]``, the
output NHWC ``[N, H/2, W/2, ndf]`` (the channels-last memory the next conv
reads as is).  ``disc_conv1`` launches the hand-written CUDA kernel
``s2r_tpu_torch/csrc/disc_conv.cu`` for CUDA tensors and takes the plain
PyTorch version ``disc_conv1_plain`` only for CPU tensors; there is no
fallback.  In bfloat16 the kernel is an implicit GEMM on the tensor cores
whose weight operand is ``pack_kernel``'s ``[16C, ndf]`` matrix, rows in
``(kh, ci, kw)`` order (the counterpart of the TPU kernel's
``pack_kernel``, in another row order); float32 keeps a CUDA-core loop on
the HWIO kernel.  One launch takes any batch.  ``DiscConv1`` is the
autograd Function: its backward is plain PyTorch in float32 (a transposed
conv for dx, the weight gradient of the conv for dK, a sum for db), as the
JAX package leaves it to XLA (disc_conv.py:186-213).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from s2r_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "s2r_disc_conv1_f32",
           torch.bfloat16: "s2r_disc_conv1_bf16"}
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def disc_conv1_plain(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """The same function as F.conv2d in float32 (float64 stays float64),
    cast back to x's type: x [N,H,C,W], kernel [4,4,C,ndf], bias [ndf] ->
    [N,H/2,W/2,ndf]."""
    f = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.permute(0, 2, 1, 3).to(f),
                 kernel.to(f).permute(3, 2, 0, 1), bias.to(f),
                 stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def pack_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO [4, 4, C, ndf] -> the bfloat16 kernel's [16*C, ndf] operand,
    row k = (kh*C + ci)*4 + kw holding kernel[kh, kw, ci]: a permute and a
    reshape, in the kernel's type and on its device."""
    kh, kw, c, ndf = kernel.shape
    if (kh, kw) != (4, 4):
        raise ValueError(f"pack_kernel: kernel {tuple(kernel.shape)} must be "
                         "[4,4,C,ndf]")
    return kernel.permute(0, 2, 1, 3).reshape(16 * c, ndf).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library with its entries' types set, once."""
    lib = build.load("disc_conv")
    for name in _DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.s2r_disc_conv1_bf16_smem.argtypes = [ctypes.c_int64]
    lib.s2r_disc_conv1_bf16_smem.restype = ctypes.c_int64
    return lib


def disc_conv1(x: torch.Tensor, kernel: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """x [N,H,C,W] (any strides), kernel HWIO [4,4,C,ndf], bias [ndf], all
    of one type (f32/bf16) -> NHWC [N, H//2, W//2, ndf] in that type:
    conv(x) + bias with float32 accumulation."""
    if x.dim() != 4:
        raise ValueError(f"disc_conv1: x {tuple(x.shape)} must be [N,H,C,W]")
    n, h, c, w = x.shape
    if kernel.dim() != 4 or kernel.shape[:3] != (4, 4, c):
        raise ValueError(f"disc_conv1: kernel {tuple(kernel.shape)} must be "
                         f"[4,4,{c},ndf]")
    ndf = kernel.shape[3]
    if bias.shape != (ndf,):
        raise ValueError(f"disc_conv1: bias {tuple(bias.shape)} must be [{ndf}]")
    if not (x.device == kernel.device == bias.device):
        raise ValueError("disc_conv1: x, kernel and bias on different devices")
    if x.device.type == "cpu":
        return disc_conv1_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"disc_conv1: no kernel for {x.device}")
    if x.dtype not in _DTYPES or kernel.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"disc_conv1: x {x.dtype}, kernel {kernel.dtype} and "
                        f"bias {bias.dtype} must all be float32 or bfloat16")
    if not (kernel.is_contiguous() and bias.is_contiguous()):
        raise ValueError("disc_conv1: kernel and bias must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("disc_conv1: x is not on the current device")
    lib = _lib()
    if x.dtype == torch.bfloat16:
        if ndf != 64:
            raise ValueError(f"disc_conv1: the bfloat16 kernel takes ndf 64, "
                             f"not {ndf}")
        if lib.s2r_disc_conv1_bf16_smem(c) > _SMEM_LIMIT:
            raise ValueError(f"disc_conv1: C={c} input tile and weights "
                             "exceed the kernel's shared memory")
        operand = pack_kernel(kernel)
    else:
        if ndf % 8 or ndf > 256:
            raise ValueError(f"disc_conv1: ndf {ndf} must be a multiple of "
                             "8, at most 256")
        if (16 * c * ndf + ndf) * 4 > _SMEM_LIMIT:
            raise ValueError(f"disc_conv1: C={c} x ndf={ndf} weights exceed "
                             "the kernel's shared memory")
        operand = kernel
    y = torch.empty((n, h // 2, w // 2, ndf), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    err = getattr(lib, _DTYPES[x.dtype])(
        x.data_ptr(), operand.data_ptr(), bias.data_ptr(), y.data_ptr(),
        n, h, c, w, *x.stride(), ndf, build.stream(x))
    build.check(err, "disc_conv1")
    disc_conv1.launches += 1
    return y


disc_conv1.launches = 0


class DiscConv1(torch.autograd.Function):
    """disc_conv1 with a plain float32 backward (float64 stays float64): dx
    [N,H,C,W] in x's type, dK HWIO and db in the kernel's type."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return disc_conv1(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        f = torch.promote_types(x.dtype, torch.float32)
        g32 = g.to(f).permute(0, 3, 1, 2)  # NCHW view
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            n, h, c, w = x.shape
            dx = torch.nn.grad.conv2d_input(
                (n, c, h, w), kernel.to(f).permute(3, 2, 0, 1), g32,
                stride=2, padding=1).permute(0, 2, 1, 3).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = torch.nn.grad.conv2d_weight(
                x.permute(0, 2, 1, 3).to(f), tuple(kernel.shape[i]
                                                     for i in (3, 2, 0, 1)),
                g32, stride=2, padding=1).permute(2, 3, 1, 0).to(kernel.dtype)
        if ctx.needs_input_grad[2]:
            db = g32.sum((0, 2, 3)).to(kernel.dtype)
        return dx, dk, db
