"""DRN-D-54 backbone (Dilated Residual Network, arch D).

The port of s2r_tpu/models/drn.py: levels 1-2 and 7-8 are plain 3x3
conv + BN + ReLU stacks, levels 3-6 Bottleneck stages (the port's ResNet
block: planes 64 s2, 128 s2, 256 at dilation 2, 512 at dilation 4).
Output stride 8 by construction.  Returns (high = level8's output
[N,512,H/8,W/8], low = level3's [N,256,H/4,W/4]).

Module names are the JAX package's torch schema (s2r_tpu/io/torch_export.py
``export_drn``): ``level{L}.conv{r}``/``bn{r}`` for the plain levels,
``level{L}.block{B}.conv1`` .. ``bn3``, ``downsample.{0,1}`` for the
residual ones.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, relu
from s2r_tpu_torch.models.resnet import Bottleneck, bottleneck_rows

# copied from s2r_tpu/models/drn.py
CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)
LAYERS_D54 = (1, 1, 3, 4, 6, 3, 1, 1)
# level -> (stride, dilation); levels 1, 2, 7, 8 are ConvStacks
LEVELS = {1: (1, 1), 2: (2, 1), 3: (2, 1), 4: (2, 1), 5: (1, 2), 6: (1, 4),
          7: (1, 2), 8: (1, 1)}
CONV_LEVELS = (1, 2, 7, 8)


class ConvStack(nn.Module):
    """`reps` x (3x3 conv + BN + ReLU), the first at `stride`."""

    def __init__(self, in_ch: int, features: int, reps: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.reps = reps
        for r in range(reps):
            setattr(self, f"conv{r + 1}",
                    Conv2d(in_ch if r == 0 else features, features, 3,
                           stride=stride if r == 0 else 1, padding=dilation,
                           dilation=dilation))
            setattr(self, f"bn{r + 1}", BatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in range(1, self.reps + 1):
            x = relu(getattr(self, f"bn{r}")(getattr(self, f"conv{r}")(x)))
        return x


class ResLevel(nn.Module):
    """`n` Bottlenecks named block1..block{n}."""

    def __init__(self, blocks: List[Tuple[int, int, int, int, bool]]):
        super().__init__()
        self.n = len(blocks)
        for b, spec in enumerate(blocks):
            setattr(self, f"block{b + 1}", Bottleneck(*spec))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for b in range(1, self.n + 1):
            x = getattr(self, f"block{b}")(x)
        return x


def res_plan(level: int, in_ch: int) -> List[Tuple[int, int, int, int, bool]]:
    """(in_ch, planes, stride, dilation, downsample) of each Bottleneck of
    a residual level, as s2r_tpu/models/drn.py builds them."""
    planes, n = CHANNELS[level - 1], LAYERS_D54[level - 1]
    stride, dilation = LEVELS[level]
    out = []
    for b in range(n):
        first = b == 0
        out.append((in_ch, planes, stride if first else 1, dilation,
                    first and (stride != 1 or in_ch != planes * 4)))
        in_ch = planes * 4
    return out


def _in_channels(level: int) -> int:
    if level == 1:
        return 3
    if level - 1 in CONV_LEVELS:
        return CHANNELS[level - 2]
    return CHANNELS[level - 2] * 4


class DRN(nn.Module):
    def __init__(self):
        super().__init__()
        for lv in range(1, 9):
            stride, dilation = LEVELS[lv]
            if lv in CONV_LEVELS:
                mod = ConvStack(_in_channels(lv), CHANNELS[lv - 1],
                                LAYERS_D54[lv - 1], stride, dilation)
            else:
                mod = ResLevel(res_plan(lv, _in_channels(lv)))
            setattr(self, f"level{lv}", mod)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (high [N,512,H/8,W/8], low [N,256,H/4,W/4])."""
        x = self.level3(self.level2(self.level1(x)))
        low = x
        for lv in range(4, 9):
            x = getattr(self, f"level{lv}")(x)
        return x, low


def param_layout():
    """(JAX path under the backbone, torch key under it, kind) of every
    conv and BatchNorm, in the JAX package's import order (the plain
    levels, then the residual ones)."""
    rows = []
    for lv in CONV_LEVELS:
        for r in range(1, LAYERS_D54[lv - 1] + 1):
            rows += [((f"level{lv}", f"conv{r}"), f"level{lv}.conv{r}", "conv"),
                     ((f"level{lv}", f"bn{r}"), f"level{lv}.bn{r}", "bn")]
    for lv in (3, 4, 5, 6):
        for b, spec in enumerate(res_plan(lv, _in_channels(lv))):
            rows += bottleneck_rows(f"level{lv}_block{b + 1}",
                                    f"level{lv}.block{b + 1}", spec[4])
    return rows
