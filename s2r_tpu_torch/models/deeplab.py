"""DeepLab-V3+ on MobileNetV2: backbone -> ASPP -> decoder -> upsample.

The port of s2r_tpu/models/deeplab.py, eval forward, MobileNetV2 backbone.
Parameters live under ``backbone.``, ``aspp.`` and ``decoder.`` with the
reference torch key names (io/convert.py fills them from JAX variables).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from s2r_tpu_torch.core.device import resolve_device, resolve_dtype
from s2r_tpu_torch.models.aspp import ASPP
from s2r_tpu_torch.models.decoder import Decoder
from s2r_tpu_torch.models.layers import init_weights
from s2r_tpu_torch.models.mobilenet import MobileNetV2
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners


class DeepLab(nn.Module):
    """Eval-mode DeepLab-V3+ (MobileNetV2, output stride 16 or 8).

    Weights are drawn from `generator` (seed 0 when None) on the CPU, then
    the module moves to `device` (``cuda`` when None; raises without a GPU).
    `dtype` is the compute dtype ('f32', 'bf16' or a torch dtype);
    parameters stay float32.
    """

    def __init__(self, num_classes: int = 19, output_stride: int = 16, *,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.output_stride = output_stride
        self.compute_dtype = resolve_dtype(dtype)
        self.backbone = MobileNetV2(output_stride)
        self.aspp = ASPP(output_stride)
        self.decoder = Decoder(num_classes)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.conv1.weight.device

    def taps(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (ASPP feature [N,256,H/os,W/os], low-level
        feature [N,24,H/4,W/4]) in the compute dtype."""
        high, low = self.backbone(x.to(self.compute_dtype))
        return self.aspp(high), low

    def forward(self, x: torch.Tensor, upsample_logits: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (logits, ASPP feature).  Logits are float32 at the
        input's size, or decoder-resolution (stride 4) in the compute dtype
        when `upsample_logits` is False."""
        feat, low = self.taps(x)
        logits = self.decoder(feat, low)
        if upsample_logits:
            logits = resize_bilinear_align_corners(
                logits, x.shape[-2:],
                dtype=torch.promote_types(x.dtype, torch.float32))
        return logits, feat
