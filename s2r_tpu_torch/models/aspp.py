"""Atrous Spatial Pyramid Pooling (s2r_tpu/models/aspp.py).

Four branches (1x1 and three 3x3 atrous convs, dilations 1/6/12/18 at output
stride 16, 1/12/24/36 at 8), each conv -> BN -> ReLU; a global-average-pool
branch (GAP -> 1x1 -> BN -> ReLU) broadcast back to the feature size (an
align-corners resize from 1x1 is a broadcast); concat -> 1x1 to 256 -> BN ->
ReLU -> Dropout(0.5), the identity in eval.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, Dropout, relu

_DILATIONS = {16: (1, 6, 12, 18), 8: (1, 12, 24, 36)}


class ASPPBranch(nn.Module):
    def __init__(self, in_ch: int, kernel_size: int, dilation: int,
                 features: int = 256):
        super().__init__()
        pad = 0 if kernel_size == 1 else dilation
        self.atrous_conv = Conv2d(in_ch, features, kernel_size, padding=pad,
                                  dilation=dilation)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    def __init__(self, output_stride: int = 16, inplanes: int = 320):
        super().__init__()
        if output_stride not in _DILATIONS:
            raise NotImplementedError(output_stride)
        d = _DILATIONS[output_stride]
        self.aspp1 = ASPPBranch(inplanes, 1, d[0])
        self.aspp2 = ASPPBranch(inplanes, 3, d[1])
        self.aspp3 = ASPPBranch(inplanes, 3, d[2])
        self.aspp4 = ASPPBranch(inplanes, 3, d[3])
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)), Conv2d(inplanes, 256, 1),
            BatchNorm(256), nn.ReLU())
        self.conv1 = Conv2d(1280, 256, 1)
        self.bn1 = BatchNorm(256)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [N,inplanes,h,w] -> [N,256,h,w]; `generator` draws the
        dropout mask in train mode."""
        branches = [self.aspp1(x), self.aspp2(x), self.aspp3(x), self.aspp4(x)]
        gap = self.global_avg_pool
        g = x.to(torch.promote_types(x.dtype, torch.float32)).mean(
            dim=(2, 3), keepdim=True).to(x.dtype)
        g = relu(gap[2](gap[1](g)))
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        y = torch.cat(branches, dim=1)
        return self.dropout(relu(self.bn1(self.conv1(y))), generator)
