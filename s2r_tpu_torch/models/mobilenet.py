"""MobileNetV2 backbone with atrous depthwise-separable convs.

The port of s2r_tpu/models/mobilenet.py.  Module names follow the reference
torch schema (``features.N.conv.j``, with ``low_level_features`` and
``high_level_features`` registered as aliases of features[0:4] and
features[4:], as the reference does), so s2r_tpu/io/torch_export.py's keys
load with ``strict=True``.

The ring: the reference zero-pads each block's input by its dilation
before the expand 1x1 conv, so the depthwise conv's padding ring holds the
ring's post-BN/ReLU6 value relu6(expand_bn shift), not zero, and in train
mode the expand BN's statistics count the ring's zeros.  Both are
analytic, never materialized: the ring value enters the depthwise conv
through Conv2d's ``fill`` identity, and BatchNorm(zero_pad_width=d) counts
the ring (the JAX package's default pad_stats=True).

``pad_stats=False`` (``--fast-pad-stats``; s2r_tpu/models/mobilenet.py
:100-126): no ring, the expand BN's statistics over the block's own
extent and the depthwise conv zero-padded.  Its eval function differs
too once an expand BN's shift is positive, as the JAX package's does
(ROADMAP C.14).  ``remat`` recomputes each inverted residual in the
backward (models/layers.py ``remat``; mobilenet.py:154-155), the stem
not.  ``stem_s2d`` computes the 3x3 stride-2 stem through space-to-depth
on an even input size (models/layers.py ``Conv2d``; :143-150).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, relu6, remat

# (expand_ratio t, out_channels c, repeats n, stride s), copied from
# s2r_tpu/models/mobilenet.py (reference mobilenet.py:78-87).
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# The low-level feature is the output of features[LOW_LEVEL_SPLIT]: the stem
# and three blocks.
LOW_LEVEL_SPLIT = 3


def block_plan(output_stride: int, width_mult: float = 1.0):
    """Per-block (in_ch, out_ch, stride, dilation, expand), copied from
    s2r_tpu/models/mobilenet.py: once the running stride reaches
    `output_stride`, later stages run at stride 1 with the previous rate as
    dilation, multiplying the rate by the stage's nominal stride."""
    plan = []
    input_channel = int(32 * width_mult)
    current_stride = 2  # after stem
    rate = 1
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        if current_stride == output_stride:
            stride, dilation = 1, rate
            rate *= s
        else:
            stride, dilation = s, 1
            current_stride *= s
        out_ch = int(c * width_mult)
        for i in range(n):
            plan.append((input_channel, out_ch, stride if i == 0 else 1,
                         dilation, t))
            input_channel = out_ch
    return plan


class InvertedResidual(nn.Module):
    """[1x1 expand + BN + ReLU6] -> 3x3 depthwise + BN + ReLU6 -> 1x1
    project + BN, with the identity residual when stride 1 and in == out."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, dilation: int,
                 expand_ratio: int, pad_stats: bool = True):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == out_ch
        self.expand = expand_ratio != 1
        self.dilation = d = dilation
        self.pad_stats = bool(pad_stats)
        layers = [Conv2d(in_ch, hidden, 1), BatchNorm(hidden), nn.ReLU6()] \
            if self.expand else []
        layers += [Conv2d(hidden, hidden, 3, stride=stride, padding=d,
                          dilation=d, groups=hidden),
                   BatchNorm(hidden), nn.ReLU6(),
                   Conv2d(hidden, out_ch, 1), BatchNorm(out_ch)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y, fill, i = x, None, 0
        if self.expand and self.pad_stats:
            y, shift = c[1](c[0](y), ring=True, zero_pad_width=self.dilation)
            fill = relu6(shift)
            y = relu6(y)
            i = 3
        elif self.expand:
            y = relu6(c[1](c[0](y)))
            i = 3
        y = relu6(c[i + 1](c[i](y, fill=fill)))
        y = c[i + 4](c[i + 3](y))
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    def __init__(self, output_stride: int = 16, width_mult: float = 1.0,
                 remat: bool = False, pad_stats: bool = True,
                 stem_s2d: bool = False):
        super().__init__()
        self.remat = bool(remat)
        stem_ch = int(32 * width_mult)
        stem = nn.Sequential(Conv2d(3, stem_ch, 3, stride=2, padding=1,
                                    s2d=stem_s2d),
                             BatchNorm(stem_ch), nn.ReLU6())
        blocks = [InvertedResidual(*p[:4], expand_ratio=p[4],
                                   pad_stats=pad_stats)
                  for p in block_plan(output_stride, width_mult)]
        self.features = nn.Sequential(stem, *blocks)
        self.low_level_features = self.features[:LOW_LEVEL_SPLIT + 1]
        self.high_level_features = self.features[LOW_LEVEL_SPLIT + 1:]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (high [N,320,H/os,W/os], low [N,24,H/4,W/4])."""
        stem = self.features[0]
        y = relu6(stem[1](stem[0](x)))
        low = None
        for i, block in enumerate(self.features[1:]):
            y = remat(block, y) if self.remat else block(y)
            if i == LOW_LEVEL_SPLIT - 1:
                low = y
        return y, low
