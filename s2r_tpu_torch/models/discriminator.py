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

``s2d_convs`` (s2r_tpu/models/discriminator.py:27,41): the first
s2d_convs convs run through space-to-depth (ops/s2d.py) on an even input
size, the direct conv otherwise.  conv1 stays on the hand-written kernel
whatever it says, and both compute one function, so it acts from conv2
on: ``s2d_convs=1`` changes nothing here.

Under row sharding (ops/halo.py) the kernel runs on the band plus 2
rows a side with its own one-row padding, its first and last output rows
dropped: output rows [r0/2, floor(r1/2)) read input rows r0-1 .. r1, and
an even start keeps the stride-2 alignment (a one-row halo would shift
it by one).  The dense convs read exactly their rows (ops/halo.py
``conv_rows``), the s2d ones as conv1 does.  Its levels (floor(H/2) at
each conv) are its own (ops/halo.py ``own_levels``); at 65 rows over 2
bands the last convs' second band is empty.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2r_tpu_torch.core.device import resolve_device, resolve_dtype
from s2r_tpu_torch.models.layers import leaky_relu, s2d_applies, s2d_rows
from s2r_tpu_torch.ops import halo
from s2r_tpu_torch.ops.kernels.disc_conv import DiscConv1
from s2r_tpu_torch.ops.s2d import conv4x4s2_via_s2d

NAMES = ("conv1", "conv2", "conv3", "conv4", "classifier")


class FCDiscriminator(nn.Module):
    def __init__(self, num_classes: int = 19, ndf: int = 64, *,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 s2d_convs: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = resolve_dtype(dtype)
        self.s2d_convs = int(s2d_convs)
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
        with halo.own_levels(x):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        sharded = halo.current() is not None
        c1 = self.conv1
        y = DiscConv1.apply((halo.halo(x, 2) if sharded else x
                             ).permute(0, 2, 1, 3),
                            c1.weight.to(dt).permute(2, 3, 1, 0).contiguous(),
                            c1.bias.to(dt)).permute(0, 3, 1, 2)
        if sharded:
            y = y[:, :, 1:-1].contiguous(memory_format=torch.channels_last)
            halo.register_strided(y, x, 4, 2, 1)
        for i, name in enumerate(NAMES[1:], start=1):
            conv = getattr(self, name)
            y = leaky_relu(y, 0.2)
            if i < self.s2d_convs and s2d_applies(conv, y):
                w = conv.weight.to(dt)
                y = ((s2d_rows(conv4x4s2_via_s2d, y, w) if sharded
                      else conv4x4s2_via_s2d(y, w))
                     + conv.bias.to(dt).view(1, -1, 1, 1))
            elif sharded:
                y = halo.conv_rows(
                    lambda r, c=conv: F.conv2d(r, c.weight.to(dt),
                                               c.bias.to(dt), stride=2,
                                               padding=(0, 1)), y, 4, 2, 1)
            else:
                y = F.conv2d(y, conv.weight.to(dt), conv.bias.to(dt),
                             stride=2, padding=1)
        return y
