"""Requantization of int32 conv accumulators to int8 (decoder-int8 serving).

The port of the TPU kernel ``s2r_tpu/ops/pallas/requant.py``
(``requant_s32_to_s8``)::

    out = clamp(round_half_even(x * m'[c] + b'[c]), 0, 127) -> int8
    m' = m * inv_a,  b' = b * inv_a   (folded first, in float32)

``requant_s32_to_s8`` launches the hand-written CUDA kernel
``s2r_tpu_torch/csrc/requant.cu`` for a CUDA tensor and takes the plain
PyTorch chain ``requant_plain`` only for a CPU tensor.  The kernel keeps the
multiply and the add as two rounded operations, so both agree bit for bit.
The kernel indexes in 32 bits, so the wrapper launches it once per run of
whole rows of the ``[M, C]`` matrix of fewer than 2^31 elements
(``over_rows``).
"""

from __future__ import annotations

import ctypes
import functools
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library with its entries' types set, once."""
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
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return y
    over_rows(x.view(-1, c), mf, bf, y.view(-1, c), _launch_requant)
    return y


requant_s32_to_s8.launches = 0


def over_rows(x: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
              y: torch.Tensor, launch, limit: int = build.INDEX_LIMIT) -> None:
    """Fill y [M, C] from x [M, C] by launch(x[r0:r1], m, b, y[r0:r1]) over
    runs of whole rows of fewer than `limit` elements each (the kernel
    indexes in 32 bits; rows are independent)."""
    if x.numel() < limit:
        launch(x, m, b, y)
        return
    for r0, r1 in build.batch_chunks(x.shape[0], x.shape[1], limit):
        launch(x[r0:r1], m, b, y[r0:r1])


def _launch_requant(x: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                    y: torch.Tensor) -> None:
    """One launch of the kernel on contiguous CUDA x [M, C], y [M, C]."""
    err = _lib().s2r_requant_s32_s8(x.data_ptr(), m.data_ptr(), b.data_ptr(),
                                    y.data_ptr(), x.numel(), x.shape[-1],
                                    build.stream(x))
    build.check(err, "requant_s32_to_s8")
    requant_s32_to_s8.launches += 1
