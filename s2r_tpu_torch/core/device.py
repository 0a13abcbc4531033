"""Device and compute-dtype resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Asking for
``cuda`` (or leaving the device unset) on a machine without a GPU raises:
the port never carries on on the CPU behind the caller's back.

The precision policy mirrors s2r_tpu/core/precision.py: parameters stay
float32, activations and conv inputs run in the compute dtype ('f32' or
'bf16'), BatchNorm statistics and interpolation in float32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """Compute dtype from a policy name ('f32', 'bf16') or a torch dtype."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown precision policy: {dtype!r}")
        return _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    return dtype
