"""Device and compute-dtype resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Asking for
``cuda`` (or leaving the device unset) on a machine without a GPU raises:
the port never carries on on the CPU behind the caller's back.

The precision policy mirrors s2r_tpu/core/precision.py: parameters stay
float32, activations and conv inputs run in the compute dtype ('f32' or
'bf16'), BatchNorm statistics and interpolation in float32.  The port adds
'f64' for reference runs on the CPU (every plain version computes in
float64 then; the kernels take float32 and bfloat16 only), which show how
far float32 rounding alone moves a result.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f64": torch.float64}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device to run on: `device`, or ``cuda`` when it is None."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("s2r_tpu_torch: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"s2r_tpu_torch: unsupported device {dev}")
    return dev


def platform_from_env() -> str:
    """'cpu' or 'cuda' from ``S2R_PLATFORM`` (unset, 'cuda' or 'gpu': the
    card)."""
    plat = os.environ.get("S2R_PLATFORM", "").strip().lower()
    if plat in ("", "cuda", "gpu"):
        return "cuda"
    if plat == "cpu":
        return "cpu"
    raise ValueError(f"s2r_tpu_torch: S2R_PLATFORM={plat!r}: the port runs on "
                     "'cuda' or 'cpu'")


def device_from_env() -> torch.device:
    """The CLI drivers' device: ``S2R_PLATFORM=cpu`` selects the CPU;
    unset or ``cuda`` the card (raising when there is none), as the JAX
    package's CLIs read the same variable (s2r_tpu/config.py:299).  On
    the card this is the current device, which a rank of data-parallel
    training has set to its own (``rank_device``)."""
    if platform_from_env() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("s2r_tpu_torch: no CUDA device is available; "
                           "set S2R_PLATFORM=cpu to run on the CPU")
    return resolve_device(None)


def rank_device(local_rank: int) -> torch.device:
    """Bind this process to ``cuda:local_rank`` (one process per card,
    torchrun's LOCAL_RANK) and return it; raises when the card is not
    there, never falling back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("s2r_tpu_torch: no CUDA device is available for "
                           f"local rank {local_rank}; set S2R_PLATFORM=cpu "
                           "to run the ranks on the CPU")
    if not 0 <= local_rank < torch.cuda.device_count():
        raise RuntimeError(f"s2r_tpu_torch: local rank {local_rank} has no "
                           f"card: {torch.cuda.device_count()} visible")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """Compute dtype from a policy name ('f32', 'bf16', 'f64') or a torch
    dtype."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown precision policy: {dtype!r}")
        return _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"compute dtype must be float32, bfloat16 or "
                         f"float64, got {dtype}")
    return dtype
