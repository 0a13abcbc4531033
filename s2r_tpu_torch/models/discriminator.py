"""Fully-convolutional output-space discriminator (s2r_tpu/models/
discriminator.py, reference modeling/discriminator.py:6-35).

Five 4x4 stride-2 padding-1 convs 19 -> 64 -> 128 -> 256 -> 512 -> 1 with
LeakyReLU(0.2) between, no BatchNorm, no sigmoid (paired with
BCE-with-logits).  The first conv runs on the hand-written kernel
(ops/kernels/disc_conv.py), reading the NCHW softmax map through its
strides; the others are ``F.conv2d`` on the channels-last memory it
writes.  Weights follow torch's default Conv2d init (U(+-1/sqrt(fan_in))
for weight and bias), drawn from an explicit ``torch.Generator``; the
module computes in its compute dtype, casting its input first as the JAX
package's Conv2d does, and keeps float32 parameters.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2r_tpu_torch.core.device import resolve_device, resolve_dtype
from s2r_tpu_torch.models.layers import leaky_relu
from s2r_tpu_torch.ops.kernels.disc_conv import DiscConv1

NAMES = ("conv1", "conv2", "conv3", "conv4", "classifier")


class FCDiscriminator(nn.Module):
    def __init__(self, num_classes: int = 19, ndf: int = 64, *,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = resolve_dtype(dtype)
        widths = (num_classes, ndf, ndf * 2, ndf * 4, ndf * 8, 1)
        for name, cin, cout in zip(NAMES, widths[:-1], widths[1:]):
            setattr(self, name, nn.Conv2d(cin, cout, 4, stride=2, padding=1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's default Conv2d init from `generator`, conv by conv,
        weight then bias (CPU generator: call before moving the module, or
        with a generator on the module's device)."""
        for name in NAMES:
            conv = getattr(self, name)
            bound = 1.0 / conv.weight[0].numel() ** 0.5
            for p in (conv.weight, conv.bias):
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, num_classes, H, W] (the softmax map) -> logits
        [N, 1, H/32, W/32] in the compute dtype."""
        dt = self.compute_dtype
        x = x.to(dt)
        c1 = self.conv1
        y = DiscConv1.apply(x.permute(0, 2, 1, 3),
                            c1.weight.to(dt).permute(2, 3, 1, 0).contiguous(),
                            c1.bias.to(dt)).permute(0, 3, 1, 2)
        for name in NAMES[1:]:
            conv = getattr(self, name)
            y = F.conv2d(leaky_relu(y, 0.2), conv.weight.to(dt),
                         conv.bias.to(dt), stride=2, padding=1)
        return y
