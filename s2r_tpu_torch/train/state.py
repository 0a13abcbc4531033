"""What the output-space adaptation step mutates (s2r_tpu/train/state.py).

The JAX package keeps parameters, BatchNorm statistics, optimizer state,
the step counter and the dropout key in one immutable pytree.  In the port
the parameters and BatchNorm statistics live in the modules (``G``, the
segmenter, and ``D``, the discriminator) and are updated in place; the
state holds the modules beside the host-side step counter, the flat
optimizer states and the dropout generator on the modules' device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    step: int                    # global iteration counter
    G: nn.Module
    D: nn.Module
    opt_state: Dict              # {'G': SGD state, 'D': Adam state}
    generator: torch.Generator   # draws the dropout masks
