"""DeepLab-V3+ decoder (s2r_tpu/models/decoder.py).

Low-level path 1x1 to 48 (from 24 channels on MobileNetV2, 128 on
Xception, 256 on ResNet and DRN) + BN + ReLU; the ASPP output resized to the
low-level size (align-corners bilinear) and concatenated (304 channels);
head 3x3 -> BN -> ReLU -> Dropout(0.5), 3x3 -> BN -> ReLU -> Dropout(0.1),
1x1 to the classes with bias.  The modules sit at the reference's
``last_conv`` indices (0, 1, 4, 5, 8 hold parameters, 3 and 7 are the
dropouts); dropout is the identity in eval.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, Dropout, relu
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners


class Decoder(nn.Module):
    def __init__(self, num_classes: int = 19, low_level_inplanes: int = 24):
        super().__init__()
        self.conv1 = Conv2d(low_level_inplanes, 48, 1)
        self.bn1 = BatchNorm(48)
        self.last_conv = nn.Sequential(
            Conv2d(304, 256, 3, padding=1), BatchNorm(256), nn.ReLU(),
            Dropout(0.5),
            Conv2d(256, 256, 3, padding=1), BatchNorm(256), nn.ReLU(),
            Dropout(0.1),
            Conv2d(256, num_classes, 1, bias=True))

    def forward(self, x: torch.Tensor, low: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(x [N,256,h,w], low [N,L,4h,4w]) -> logits [N,classes,4h,4w];
        `generator` draws the dropout masks in train mode."""
        low = relu(self.bn1(self.conv1(low)))
        x = resize_bilinear_align_corners(x, low.shape[-2:])
        y = torch.cat([x, low], dim=1)
        lc = self.last_conv
        y = lc[3](relu(lc[1](lc[0](y))), generator)
        y = lc[7](relu(lc[5](lc[4](y))), generator)
        return lc[8](y)
