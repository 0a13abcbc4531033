"""What a train step mutates (s2r_tpu/train/state.py).

The JAX package keeps parameters, BatchNorm statistics, optimizer state,
the step counter and the dropout key in one immutable pytree.  In the port
the parameters and BatchNorm statistics live in the modules (``G``, the
segmenter, and ``D``, the discriminator) and are updated in place; the
state holds the modules beside the host-side step counter, the flat
optimizer states and the dropout generator on the modules' device.

Per method (train/setup.py):
- output_adapt: D is the FCDiscriminator; opt_state = {'G': SGD state over
  G, 'D': Adam state over D};
- feature_adapt and source_only: D is the DomainClassifier; opt_state =
  {'task' over G, 'd' over D, 'd_inv' over f = backbone + ASPP, 'c' over
  G}, each an SGD or Adam state ('c' is never stepped, train.py:202-204).
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
    D: nn.Module                 # discriminator or domain classifier
    opt_state: Dict              # one flat state per optimizer (above)
    generator: torch.Generator   # draws the dropout masks
