"""Layers with the JAX package's semantics (s2r_tpu/models/layers.py).

Modules are NCHW and keep their parameters in float32; each computes in the
dtype of its input, which the model sets once at its entry.  Parameter names
follow torch's own layers, so the reference torch key schema loads with
``load_state_dict(strict=True)``.

- ``Conv2d``: the ``fill`` ring identity conv(pad_v(x)) = conv(pad_0(x - v))
  + v * sum(kernel) for depthwise convs, with gradients to x, the weight
  and ``fill``.  Stride-1 3x3 depthwise convs run on the hand-written
  kernels, forward and backward (ops/kernels/depthwise.py); stride-2
  depthwise and all dense convs stay ``F.conv2d``, as the JAX package
  leaves them to XLA.
- ``BatchNorm``: in eval, x * inv + shift with inv = rsqrt(var + eps) *
  scale and shift = bias - mean * inv from the running statistics, in
  float32, and the affine in the compute dtype.  In train mode, both
  directions on the hand-written BatchNorm kernels
  (ops/kernels/batchnorm.py): the batch statistics with the
  zero-padding-ring count, the running-statistics update of torch, y and
  dx.  Either can return ``shift``, the value a zero padding ring takes
  after normalization.
- ``Dropout``: elementwise, kept values scaled by 1/keep, the mask drawn
  from a caller's ``torch.Generator``; the identity in eval.
- ``relu``, ``relu6``, ``leaky_relu`` with the JAX package's subgradients
  at the kinks (see each).  Their forward values are those of clamp, so
  the serving path computes what it computed before.
- ``init_weights``: torch's kaiming_normal (fan_in) for conv kernels, the
  torch default uniform for conv biases, BatchNorm scale 1 and bias 0, all
  drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2r_tpu_torch.ops.kernels.batchnorm import BatchNormTrain
from s2r_tpu_torch.ops.kernels.depthwise import DepthwiseConv3x3


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
            y = DepthwiseConv3x3.apply(
                x.permute(0, 2, 3, 1).contiguous(),
                w[:, 0].permute(1, 2, 0).contiguous(),
                self.dilation[0]).permute(0, 3, 1, 2)
        else:
            y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation,
                         self.groups)
        if fill is not None:
            ksum = self.weight.sum(dim=(1, 2, 3))  # [C], float32
            y = y + _col((fill * ksum).to(y.dtype))
        if self.bias is not None:
            y = y + _col(self.bias.to(y.dtype))
        return y


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and buffers with the JAX package's
    forward: running statistics in eval, batch statistics in train mode."""

    def forward(self, x: torch.Tensor, ring: bool = False,
                zero_pad_width: int = 0):
        """x [N,C,H,W] -> y, or (y, shift) when `ring`: shift [C] float32 is
        what a zero padding ring around the BN input becomes.

        In train mode the statistics are taken as if x were zero-padded by
        `zero_pad_width` on both spatial sides (s2r_tpu/models/layers.py
        :330-336): the sums are unchanged and the count is N*(H+2d)*(W+2d).
        The running mean and the unbiased running variance over that count
        are updated in place with momentum 0.1 (:341-349)."""
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            shift = self.bias - self.running_mean * inv
            y = x * _col(inv.to(x.dtype)) + _col(shift.to(x.dtype))
            return (y, shift) if ring else y
        y, shift, _, _ = BatchNormTrain.apply(
            x, self.weight, self.bias, self.eps, int(zero_pad_width),
            self.running_mean, self.running_var, float(self.momentum))
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
        return (y, shift) if ring else y


class Dropout(nn.Module):
    """Elementwise dropout (the reference's nn.Dropout): in train mode each
    element is kept with probability 1 - rate and scaled by 1/(1 - rate),
    the mask drawn from `generator` (the device's default generator when
    None); the gradient passes through the kept elements only.  The
    identity in eval, and while `enabled` is False (``set_dropout``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.enabled = True

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not (self.training and self.enabled) or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
        return torch.where(mask, x / keep, x.new_zeros(()))


def set_dropout(module: nn.Module, enabled: bool) -> None:
    """Switch every Dropout under `module` on or off (off: the identity
    also in train mode, for runs that must be deterministic)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.enabled = bool(enabled)


class _Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g, torch.where(x == 0, 0.5 * g,
                                                 g.new_zeros(())))


class _Relu6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0, 6)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (x < 6), g, g.new_zeros(()))


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0).  Gradient 1 for x > 0, 0 for x < 0 and 0.5 at x = 0:
    jax.grad of the JAX package's relu (jnp.maximum splits a tie evenly),
    where torch's clamp passes 1."""
    return _Relu.apply(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 6).  Gradient 1 strictly inside (0, 6) and 0 at both
    kinks, the JAX package's custom JVP (s2r_tpu/models/layers.py:359-377),
    where torch's clamp passes 1 at 0 and at 6.  The padded rings park many
    activations exactly on the 0 kink, so the rule moves training."""
    return _Relu6.apply(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """x for x >= 0, else negative_slope * x.  Gradient 1 at x = 0, as in
    the JAX package's jnp.where form, where F.leaky_relu gives the slope."""
    return torch.where(x >= 0, x, x * negative_slope)


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
