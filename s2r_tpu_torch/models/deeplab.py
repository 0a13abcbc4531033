"""DeepLab-V3+: backbone -> ASPP -> decoder -> upsample.

The port of s2r_tpu/models/deeplab.py, in eval and in train mode
(``module.train()``: batch-statistics BatchNorm and dropout), on each
backbone of the JAX package's factory: ``mobilenet`` (MobileNetV2),
``resnet``/``resnet101`` and ``resnet50``, ``xception`` (Aligned
Xception-65) and ``drn`` (DRN-D-54, output stride 8 by construction: its
ASPP runs at 8 whatever ``output_stride`` says).
Parameters live under ``backbone.``, ``aspp.`` and ``decoder.`` with the
reference torch key names (io/convert.py fills them from JAX variables);
the 1x/10x learning-rate groups follow those prefixes (train/setup.py).

``freeze_bn`` (deeplab.py:35-40) keeps every submodule in eval while the
model trains, as the JAX package does by handing ``train and not
freeze_bn`` to every layer: running-statistics BatchNorm and no dropout.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from s2r_tpu_torch.core.device import resolve_device, resolve_dtype
from s2r_tpu_torch.models.aspp import ASPP
from s2r_tpu_torch.models.decoder import Decoder
from s2r_tpu_torch.models.layers import init_weights
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners

BACKBONES = ("mobilenet", "resnet", "resnet101", "resnet50", "xception",
             "drn")
# backbone family -> (ASPP inplanes, decoder low_level_inplanes), the
# reference's assp.py:41-42 and decoder.py:10-13
WIDTHS = {"mobilenet": (320, 24), "resnet": (2048, 256),
          "xception": (2048, 128), "drn": (512, 256)}


def family(backbone: str) -> str:
    """'resnet101' and 'resnet50' -> 'resnet'; the other names are their
    own family."""
    if backbone not in BACKBONES:
        raise NotImplementedError(backbone)
    return "resnet" if backbone.startswith("resnet") else backbone


def aspp_stride(backbone: str, output_stride: int) -> int:
    """The output stride ASPP's dilations follow: 8 for DRN (its levels are
    dilated past stride 8), else `output_stride`."""
    return 8 if backbone == "drn" else output_stride


def make_backbone(backbone: str, output_stride: int = 16) -> nn.Module:
    """The backbone module of a factory name (s2r_tpu/models/deeplab.py
    :71-93)."""
    fam = family(backbone)
    if fam == "mobilenet":
        from s2r_tpu_torch.models.mobilenet import MobileNetV2
        return MobileNetV2(output_stride)
    if fam == "resnet":
        from s2r_tpu_torch.models.resnet import ResNet, depth_of
        return ResNet(depth_of(backbone), output_stride)
    if fam == "xception":
        from s2r_tpu_torch.models.xception import AlignedXception
        return AlignedXception(output_stride)
    from s2r_tpu_torch.models.drn import DRN
    return DRN()


class DeepLab(nn.Module):
    """DeepLab-V3+ (`backbone`, output stride 16 or 8), built in eval mode.

    Weights are drawn from `generator` (seed 0 when None) on the CPU, then
    the module moves to `device` (``cuda`` when None; raises without a GPU).
    `dtype` is the compute dtype ('f32', 'bf16' or a torch dtype);
    parameters stay float32.
    """

    def __init__(self, num_classes: int = 19, output_stride: int = 16, *,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 freeze_bn: bool = False, backbone: str = "mobilenet"):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.output_stride = output_stride
        self.backbone_name = backbone
        self.compute_dtype = resolve_dtype(dtype)
        self.freeze_bn = bool(freeze_bn)
        inplanes, low_level = WIDTHS[family(backbone)]
        self.backbone = make_backbone(backbone, output_stride)
        self.aspp = ASPP(aspp_stride(backbone, output_stride), inplanes)
        self.decoder = Decoder(num_classes, low_level)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.conv1.weight.device

    def train(self, mode: bool = True) -> "DeepLab":
        """Train mode for every submodule, unless `freeze_bn` holds them in
        eval; ``self.training`` follows `mode` either way."""
        super().train(mode and not self.freeze_bn)
        self.training = bool(mode)
        return self

    def taps(self, x: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (ASPP feature [N,256,H/os,W/os], low-level
        feature [N,L,H/4,W/4]) in the compute dtype; L is 24 for
        MobileNetV2, 256 for ResNet and DRN, 128 for Xception (WIDTHS)."""
        high, low = self.backbone(x.to(self.compute_dtype))
        return self.aspp(high, generator), low

    def forward(self, x: torch.Tensor, upsample_logits: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,3,H,W] -> (logits, ASPP feature).  Logits are float32 (float64
        under 'f64') at the input's size, or decoder-resolution (stride 4)
        in the compute dtype
        when `upsample_logits` is False.  In train mode `generator` draws
        the dropout masks."""
        feat, low = self.taps(x, generator)
        logits = self.decoder(feat, low, generator)
        if upsample_logits:
            logits = resize_bilinear_align_corners(
                logits, x.shape[-2:], dtype=torch.promote_types(
                    x.dtype, torch.promote_types(self.compute_dtype,
                                                 torch.float32)))
        return logits, feat
