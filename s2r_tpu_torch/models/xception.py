"""Aligned Xception-65 backbone (DeepLab-V3+ variant).

The port of s2r_tpu/models/xception.py.  Entry flow: 3x3/2 conv(32) + 3x3
conv(64), then residual blocks of separable convs to 128 / 256 / 728
channels; middle flow: 16 blocks of three 728-channel separable convs;
exit flow: a block 728 -> 1024, then three separable convs 1536, 1536,
2048, each + BN + ReLU.  Output stride 16: block3 at stride 2, dilations
(1, 2) in the exit flow; 8: block3 at stride 1, the middle flow at
dilation 2 and the exit flow at (2, 4).  Returns (high [N,2048,H/os,W/os],
low = relu(block1) [N,128,H/4,W/4]).

A separable conv is a 3x3 depthwise conv padded by its dilation, a
BatchNorm, then the 1x1 pointwise conv, with no ReLU between.  Its
stride-1 depthwise convs run on the hand-written kernels, forward and
backward (models/layers.py ``Conv2d``); the stride-2 ones stay
``F.conv2d``, as the JAX package leaves them to XLA.

Module names are the JAX package's torch schema (s2r_tpu/io/torch_export.py
``export_xception``): ``block{k}.sep{r}.{conv1,bn,pointwise}``,
``block{k}.bn{r}``, ``block{k}.skip``/``skipbn``, ``conv{3,4,5}`` and
``bn{3,4,5}``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, relu

# output stride -> (block3's stride, the middle flow's dilation, the exit
# flow's dilations), from s2r_tpu/models/xception.py
STRIDES = {16: (2, 1, (1, 2)), 8: (1, 2, (2, 4))}
MIDDLE_BLOCKS = 16
EXIT_CONVS = (("conv3", 1536), ("conv4", 1536), ("conv5", 2048))


def block_specs():
    """(name, reps, has_skip) of each XceptionBlock, as
    s2r_tpu/io/torch_export.py ``_xception_block_specs`` lists them."""
    specs = [("block1", 2, True), ("block2", 2, True), ("block3", 2, True)]
    specs += [(f"block{i + 4}", 3, False) for i in range(MIDDLE_BLOCKS)]
    return specs + [("block20", 2, True)]


class SeparableConv(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, in_ch, 3, stride=stride, padding=dilation,
                            dilation=dilation, groups=in_ch)
        self.bn = BatchNorm(in_ch)
        self.pointwise = Conv2d(in_ch, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.bn(self.conv1(x)))


class XceptionBlock(nn.Module):
    """`reps` x ([ReLU] separable conv + BN), the last at `stride`, plus
    the identity or a 1x1 strided conv + BN skip."""

    def __init__(self, in_ch: int, features: int, reps: int, stride: int = 1,
                 dilation: int = 1, start_with_relu: bool = True,
                 grow_first: bool = True):
        super().__init__()
        self.reps, self.start_with_relu = reps, start_with_relu
        widths = [features] * reps if grow_first else \
            [in_ch] * (reps - 1) + [features]
        c = in_ch
        for r, w in enumerate(widths):
            setattr(self, f"sep{r + 1}",
                    SeparableConv(c, w, stride if r == reps - 1 else 1,
                                  dilation))
            setattr(self, f"bn{r + 1}", BatchNorm(w))
            c = w
        self.has_skip = stride != 1 or in_ch != features
        if self.has_skip:
            self.skip = Conv2d(in_ch, features, 1, stride=stride)
            self.skipbn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for r in range(1, self.reps + 1):
            if r > 1 or self.start_with_relu:
                y = relu(y)
            y = getattr(self, f"bn{r}")(getattr(self, f"sep{r}")(y))
        sc = self.skipbn(self.skip(x)) if self.has_skip else x
        return y + sc


class AlignedXception(nn.Module):
    def __init__(self, output_stride: int = 16):
        super().__init__()
        if output_stride not in STRIDES:
            raise NotImplementedError(output_stride)
        entry3, mid_dil, exit_dil = STRIDES[output_stride]
        self.conv1 = Conv2d(3, 32, 3, stride=2, padding=1)
        self.bn1 = BatchNorm(32)
        self.conv2 = Conv2d(32, 64, 3, padding=1)
        self.bn2 = BatchNorm(64)
        self.block1 = XceptionBlock(64, 128, 2, stride=2,
                                    start_with_relu=False)
        self.block2 = XceptionBlock(128, 256, 2, stride=2)
        self.block3 = XceptionBlock(256, 728, 2, stride=entry3)
        for i in range(MIDDLE_BLOCKS):
            setattr(self, f"block{i + 4}",
                    XceptionBlock(728, 728, 3, dilation=mid_dil))
        self.block20 = XceptionBlock(728, 1024, 2, dilation=exit_dil[0],
                                     grow_first=False)
        c = 1024
        for name, w in EXIT_CONVS:
            setattr(self, name, SeparableConv(c, w, dilation=exit_dil[1]))
            setattr(self, f"bn{name[-1]}", BatchNorm(w))
            c = w

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (high [N,2048,H/os,W/os], low [N,128,H/4,W/4])."""
        x = relu(self.bn1(self.conv1(x)))
        x = relu(self.bn2(self.conv2(x)))
        x = self.block1(x)
        low = relu(x)
        for name, _, _ in block_specs()[1:]:
            x = getattr(self, name)(x)
        x = relu(x)
        for name, _ in EXIT_CONVS:
            x = relu(getattr(self, f"bn{name[-1]}")(getattr(self, name)(x)))
        return x, low


def _sep_rows(jax_path, key):
    return [(jax_path + ("dw",), f"{key}.conv1", "conv"),
            (jax_path + ("dw_bn",), f"{key}.bn", "bn"),
            (jax_path + ("pw",), f"{key}.pointwise", "conv")]


def param_layout():
    """(JAX path under the backbone, torch key under it, kind) of every
    conv and BatchNorm, in the JAX package's import order (the same as
    this module's registration order)."""
    rows = [(("conv1",), "conv1", "conv"), (("bn1",), "bn1", "bn"),
            (("conv2",), "conv2", "conv"), (("bn2",), "bn2", "bn")]
    for name, reps, has_skip in block_specs():
        for r in range(1, reps + 1):
            rows += _sep_rows((name, f"sep{r}"), f"{name}.sep{r}")
            rows.append(((name, f"bn{r}"), f"{name}.bn{r}", "bn"))
        if has_skip:
            rows += [((name, "skip_conv"), f"{name}.skip", "conv"),
                     ((name, "skip_bn"), f"{name}.skipbn", "bn")]
    for name, _ in EXIT_CONVS:
        rows += _sep_rows((name,), name)
        rows.append(((f"{name}_bn",), f"bn{name[-1]}", "bn"))
    return rows
