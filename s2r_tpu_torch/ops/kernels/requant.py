"""Requantization of int32 conv accumulators to int8 (decoder-int8 serving).

The port of the TPU kernel ``s2r_tpu/ops/pallas/requant.py``
(``requant_s32_to_s8``)::

    out = clamp(round_half_even(x * m'[c] + b'[c]), 0, 127) -> int8
    m' = m * inv_a,  b' = b * inv_a   (folded first, in float32)

``requant_s32_to_s8`` launches the hand-written CUDA kernel
``s2r_tpu_torch/csrc/requant.cu`` for a CUDA tensor and takes the plain
PyTorch chain ``requant_plain`` only for a CPU tensor.  The kernel keeps the
multiply and the add as two rounded operations, so both agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from s2r_tpu_torch.ops.kernels import build


def requant_plain(x: torch.Tensor, m: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """clamp(round(x*m + b), 0, 127) -> int8 with m, b already folded."""
    z = x.float() * m + b
    return torch.clamp(torch.round(z), 0, 127).to(torch.int8)


def _fold(m, b, inv_a, device) -> tuple:
    """(m*inv_a, b*inv_a) as float32 tensors on `device` (the TPU wrapper's
    fold, s2r_tpu/ops/pallas/requant.py:76-80: two float32 multiplies)."""
    mf = torch.as_tensor(m, dtype=torch.float32, device=device)
    bf = torch.as_tensor(b, dtype=torch.float32, device=device)
    if inv_a is not None:
        inv = torch.as_tensor(inv_a, dtype=torch.float32, device=device)
        mf, bf = mf * inv, bf * inv
    return mf.contiguous(), bf.contiguous()


def _lib() -> ctypes.CDLL:
    lib = build.load("requant")
    lib.s2r_requant_s32_s8.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int64] * 2
                                       + [ctypes.c_void_p])
    lib.s2r_requant_s32_s8.restype = ctypes.c_int
    return lib


def requant_s32_to_s8(x: torch.Tensor, m, b,
                      inv_a: Optional[float] = None) -> torch.Tensor:
    """x int32 [..., C]; m, b float32 [C]; inv_a an optional float32 scalar
    folded into m and b first -> int8 [..., C]."""
    if x.dtype != torch.int32 or x.dim() < 1:
        raise TypeError(f"requant_s32_to_s8: x must be int32 [..., C], got "
                        f"{x.dtype} {tuple(x.shape)}")
    c = x.shape[-1]
    mf, bf = _fold(m, b, inv_a, x.device)
    if mf.shape != (c,) or bf.shape != (c,):
        raise ValueError(f"requant_s32_to_s8: m {tuple(mf.shape)} and b "
                         f"{tuple(bf.shape)} must be [{c}]")
    if x.device.type == "cpu":
        return requant_plain(x, mf, bf)
    if x.device.type != "cuda":
        raise ValueError(f"requant_s32_to_s8: no kernel for {x.device}")
    if not x.is_contiguous():
        raise ValueError("requant_s32_to_s8: x must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("requant_s32_to_s8: x is not on the current device")
    if x.numel() >= 2 ** 31:
        raise ValueError("requant_s32_to_s8: the kernel indexes in 32 bits; "
                         f"split the batch ({x.numel()} elements)")
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return y
    err = _lib().s2r_requant_s32_s8(x.data_ptr(), mf.data_ptr(), bf.data_ptr(),
                                    y.data_ptr(), x.numel(), c,
                                    torch.cuda.current_stream().cuda_stream)
    build.check(err, "requant_s32_to_s8")
    requant_s32_to_s8.launches += 1
    return y


requant_s32_to_s8.launches = 0
