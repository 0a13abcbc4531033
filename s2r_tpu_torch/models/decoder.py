"""DeepLab-V3+ decoder, eval forward (s2r_tpu/models/decoder.py).

Low-level path 1x1 24->48 + BN + ReLU; the ASPP output resized to the
low-level size (align-corners bilinear) and concatenated (304 channels);
head 3x3 -> BN -> ReLU, 3x3 -> BN -> ReLU, 1x1 to the classes with bias.
Dropout is the identity in eval; the Dropout modules only keep the
reference's ``last_conv`` indices (0, 1, 4, 5, 8 hold parameters).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, relu
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners


class Decoder(nn.Module):
    def __init__(self, num_classes: int = 19, low_level_inplanes: int = 24):
        super().__init__()
        self.conv1 = Conv2d(low_level_inplanes, 48, 1)
        self.bn1 = BatchNorm(48)
        self.last_conv = nn.Sequential(
            Conv2d(304, 256, 3, padding=1), BatchNorm(256), nn.ReLU(),
            nn.Dropout(0.5),
            Conv2d(256, 256, 3, padding=1), BatchNorm(256), nn.ReLU(),
            nn.Dropout(0.1),
            Conv2d(256, num_classes, 1, bias=True))

    def forward(self, x: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        """(x [N,256,h,w], low [N,24,4h,4w]) -> logits [N,classes,4h,4w]."""
        low = relu(self.bn1(self.conv1(low)))
        x = resize_bilinear_align_corners(x, low.shape[-2:])
        y = torch.cat([x, low], dim=1)
        lc = self.last_conv
        y = relu(lc[1](lc[0](y)))
        y = relu(lc[5](lc[4](y)))
        return lc[8](y)
