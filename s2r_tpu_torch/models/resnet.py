"""ResNet-101 / ResNet-50 backbone with atrous layer3/layer4.

The port of s2r_tpu/models/resnet.py: a 7x7/2 stem + 3x3/2 max-pool, then
four stages of Bottleneck blocks (planes 64, 128, 256, 512; expansion 4),
layer4 with the multi-grid (1, 2, 4).  Output stride 16: layer4 at stride
1, dilation 2; output stride 8: layer3 at dilation 2, layer4 at 4.
Returns (high [N,2048,H/os,W/os], low = layer1's output [N,256,H/4,W/4]).

Module names follow torchvision (``conv1``, ``bn1``, ``layer{L}.{B}.conv1``
.. ``bn3``, ``layer{L}.0.downsample.{0,1}``), so s2r_tpu/io/torch_export.py
``export_resnet``'s keys load with ``strict=True``, and so does a
torchvision state dict without its ``fc.*`` keys.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, relu

# copied from s2r_tpu/models/resnet.py
LAYER_BLOCKS = {"resnet101": (3, 4, 23, 3), "resnet50": (3, 4, 6, 3)}
MULTI_GRID = (1, 2, 4)
PLANES = (64, 128, 256, 512)
# output stride -> (stride, dilation) of each stage
STAGES = {16: ((1, 2, 2, 1), (1, 1, 1, 2)), 8: ((1, 2, 1, 1), (1, 1, 2, 4))}


def depth_of(backbone: str) -> str:
    """The factory name ('resnet', 'resnet101' or 'resnet50') -> the
    LAYER_BLOCKS key, as s2r_tpu/models/deeplab.py reads it."""
    return "resnet50" if backbone == "resnet50" else "resnet101"


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, stride 2, padding 1): the JAX package's -inf
    padded reduce_window max.  The gradient goes to one maximum of each
    window; the input follows a ReLU, so the only ties are zeros, whose
    gradient the ReLU stops either way."""
    return F.max_pool2d(x, 3, 2, 1)


class Bottleneck(nn.Module):
    """1x1 -> BN -> ReLU -> 3x3 (stride, dilation) -> BN -> ReLU -> 1x1
    (4 x planes) -> BN, plus the identity or the 1x1 strided downsample +
    BN, then ReLU."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = Conv2d(in_ch, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = (nn.Sequential(Conv2d(in_ch, out_ch, 1,
                                                stride=stride),
                                         BatchNorm(out_ch))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.bn1(self.conv1(x)))
        y = relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = x if self.downsample is None else \
            self.downsample[1](self.downsample[0](x))
        return relu(y + sc)


def block_plan(depth: str, output_stride: int
               ) -> List[List[Tuple[int, int, int, int, bool]]]:
    """Per stage, per block (in_ch, planes, stride, dilation, downsample),
    the rules of s2r_tpu/models/resnet.py."""
    if output_stride not in STAGES:
        raise NotImplementedError(output_stride)
    strides, dilations = STAGES[output_stride]
    plan, in_ch = [], 64
    for li, n in enumerate(LAYER_BLOCKS[depth]):
        stage = []
        for bi in range(n):
            dil = dilations[li]
            if li == 3:
                dil *= MULTI_GRID[min(bi, len(MULTI_GRID) - 1)]
            down = bi == 0 and (strides[li] != 1 or in_ch != PLANES[li] * 4)
            stage.append((in_ch, PLANES[li], strides[li] if bi == 0 else 1,
                          dil, down))
            in_ch = PLANES[li] * 4
        plan.append(stage)
    return plan


class ResNet(nn.Module):
    def __init__(self, depth: str = "resnet101", output_stride: int = 16):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = BatchNorm(64)
        for li, stage in enumerate(block_plan(depth, output_stride)):
            setattr(self, f"layer{li + 1}",
                    nn.Sequential(*[Bottleneck(*b) for b in stage]))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (high [N,2048,H/os,W/os], low [N,256,H/4,W/4])."""
        y = max_pool_3x3_s2(relu(self.bn1(self.conv1(x))))
        low = y = self.layer1(y)
        y = self.layer4(self.layer3(self.layer2(y)))
        return y, low


def bottleneck_rows(jax_name: str, key: str, downsample: bool):
    """(JAX path, torch key, kind) of a Bottleneck's layers in the order
    s2r_tpu/io/torch_import.py imports them: the convs, then the
    BatchNorms, then the downsample."""
    rows = [((jax_name, s), f"{key}.{s}", "conv")
            for s in ("conv1", "conv2", "conv3")]
    rows += [((jax_name, s), f"{key}.{s}", "bn") for s in ("bn1", "bn2", "bn3")]
    if downsample:
        rows += [((jax_name, "downsample_conv"), f"{key}.downsample.0", "conv"),
                 ((jax_name, "downsample_bn"), f"{key}.downsample.1", "bn")]
    return rows


def param_layout(depth: str = "resnet101"):
    """(JAX path under the backbone, torch key under it, kind) of every
    conv and BatchNorm, in the JAX package's import order."""
    rows = [(("conv1",), "conv1", "conv"), (("bn1",), "bn1", "bn")]
    for li, stage in enumerate(block_plan(depth, 16)):
        for bi, b in enumerate(stage):
            rows += bottleneck_rows(f"layer{li + 1}_{bi}",
                                    f"layer{li + 1}.{bi}", b[4])
    return rows
