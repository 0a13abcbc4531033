"""Channel argmax with first-index ties (s2r_tpu/ops/argmax.py argmax_first).

``torch.argmax`` documents that it returns the index of the first maximal
value, the tie rule of ``np.argmax`` and ``jnp.argmax``, so one call covers
both of the JAX package's forms (the exact ``jnp.argmax`` of the full-res path
and ``argmax_first`` of the decoder-res path).  Inputs must be NaN-free.
"""

from __future__ import annotations

import torch


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum along `dim`, as int64."""
    return torch.argmax(x, dim=dim)
