"""Layers with the JAX package's eval semantics (s2r_tpu/models/layers.py).

Modules are NCHW and keep their parameters in float32; each computes in the
dtype of its input, which the model sets once at its entry.  Parameter names
follow torch's own layers, so the reference torch key schema loads with
``load_state_dict(strict=True)``.

- ``Conv2d``: the ``fill`` ring identity conv(pad_v(x)) = conv(pad_0(x - v))
  + v * sum(kernel) for depthwise convs.  Stride-1 3x3 depthwise convs run
  on the hand-written kernel (ops/kernels/depthwise.py); stride-2 depthwise
  and all dense convs stay ``F.conv2d``, as the JAX package leaves them to
  XLA.
- ``BatchNorm``: eval BatchNorm as x * inv + shift, with inv = rsqrt(var +
  eps) * scale and shift = bias - mean * inv in float32 and the affine in
  the compute dtype; it can return ``shift``, the value a zero padding ring
  takes after normalization.
- ``relu``, ``relu6``.
- ``init_weights``: torch's kaiming_normal (fan_in) for conv kernels, the
  torch default uniform for conv biases, BatchNorm scale 1 and bias 0, all
  drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2r_tpu_torch.ops.kernels.depthwise import depthwise_conv3x3


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class Conv2d(nn.Conv2d):
    """nn.Conv2d's parameters with the JAX package's Conv2d forward."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups,
                         bias=bias)

    @property
    def dw_stride1_3x3(self) -> bool:
        """A stride-1 3x3 depthwise conv padded by its dilation: the kernel's
        function."""
        return (self.groups == self.in_channels == self.out_channels
                and self.kernel_size == (3, 3) and self.stride == (1, 1)
                and self.padding == self.dilation
                and self.dilation[0] == self.dilation[1])

    def forward(self, x: torch.Tensor,
                fill: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N,C,H,W] -> [N,O,H',W'] in x's dtype.  `fill` ([C] float32,
        depthwise only): convolve as if the padding ring held `fill`."""
        w = self.weight.to(x.dtype)
        if fill is not None:
            if self.groups != self.in_channels or self.out_channels != self.in_channels:
                raise ValueError("fill is only defined for depthwise convs")
            x = x - _col(fill.to(x.dtype))
        if self.dw_stride1_3x3:
            y = depthwise_conv3x3(x.permute(0, 2, 3, 1).contiguous(),
                                  w[:, 0].permute(1, 2, 0).contiguous(),
                                  self.dilation[0]).permute(0, 3, 1, 2)
        else:
            y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation,
                         self.groups)
        if fill is not None:
            ksum = self.weight.sum(dim=(1, 2, 3))  # [C], float32
            y = y + _col((fill.float() * ksum).to(y.dtype))
        if self.bias is not None:
            y = y + _col(self.bias.to(y.dtype))
        return y


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and buffers with the JAX package's eval
    forward.  Training-mode statistics come with the training slice; this
    forward always normalizes with the running statistics."""

    def forward(self, x: torch.Tensor, ring: bool = False):
        """x [N,C,H,W] -> y, or (y, shift) when `ring`: shift [C] float32 is
        what a zero padding ring around the BN input becomes."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        y = x * _col(inv.to(x.dtype)) + _col(shift.to(x.dtype))
        return (y, shift) if ring else y


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every Conv2d and BatchNorm under `module` in registration
    order from `generator` (CPU tensors: call before moving the module)."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            if m.bias is not None:
                bound = 1.0 / fan_in ** 0.5
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
