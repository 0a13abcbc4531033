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
  leaves them to XLA.  A tuple input is convolved as the channel-concat
  of its parts without building it (``split_concat``).
- ``BatchNorm``: in eval, x * inv + shift with inv = rsqrt(var + eps) *
  scale and shift = bias - mean * inv from the running statistics, in
  float32, and the affine in the compute dtype.  In train mode, both
  directions on the hand-written BatchNorm kernels
  (ops/kernels/batchnorm.py): the batch statistics with the
  zero-padding-ring count, the running-statistics update of torch, y and
  dx.  Either can return ``shift``, the value a zero padding ring takes
  after normalization.  Under data-parallel training
  (``set_batchnorm_sync``) the train-mode statistics are the global
  batch's, through the kernels' split entries and an all-reduce.
- ``Dropout``: elementwise, kept values scaled by 1/keep, the mask drawn
  from a caller's ``torch.Generator``; the identity in eval.
- ``bn_real_batch(k, total)``: masked batch padding
  (s2r_tpu/models/layers.py:219-244).  Inside it, train-mode BatchNorm
  takes its statistics, its running update and its backward sums over
  the first k samples only (the padding samples take the affine), and
  Dropout draws the masks of the first k samples at [k, ...] and drops
  the rest, so a padded step draws what the unpadded one draws, on any
  device.  Under synchronized BatchNorm `total` is the real samples over
  the group (each rank's k may differ, and may be 0).
- ``remat(fn, *args)``: fn(*args) under torch.utils.checkpoint, its
  activations recomputed in the backward (the JAX package's nn.remat).
  The recompute changes no value and no state: each train-mode BatchNorm
  reuses the statistics its forward took (no statistics launch, no
  running update, no all-reduce, no count of batches) and each Dropout
  replays the generator state its forward drew from, on a copy, so the
  caller's generator advances once.
- ``relu``, ``relu6``, ``leaky_relu`` with the JAX package's subgradients
  at the kinks (see each).  Their forward values are those of clamp, so
  the serving path computes what it computed before.
- ``init_weights``: torch's kaiming_normal (fan_in) for conv kernels, the
  torch default uniform for conv biases, BatchNorm scale 1 and bias 0, all
  drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from s2r_tpu_torch.ops import halo
from s2r_tpu_torch.ops.kernels.batchnorm import BatchNormTrain
from s2r_tpu_torch.ops.kernels.depthwise import DepthwiseConv3x3
from s2r_tpu_torch.ops.s2d import conv3x3s2_via_s2d, conv4x4s2_via_s2d

# The real batch (bn_real_batch) and the remat region being run, per
# thread: the backward, and so a recompute, may run on autograd's own
# thread, and enters its recompute context there.
_local = threading.local()


class bn_real_batch:
    """Context manager: train-mode BatchNorm and Dropout treat only the
    first `n` samples of a batch as real (None: all), as the JAX package's
    does while it traces (s2r_tpu/models/layers.py:219-244).  `total`:
    the real samples of every rank's batch, which synchronized BatchNorm
    counts (None: each rank's batch holds as many as this one)."""

    def __init__(self, n: Optional[int], total: Optional[int] = None):
        self.real = (n, total)

    def __enter__(self):
        self._prev = getattr(_local, "real", (None, None))
        _local.real = self.real

    def __exit__(self, *exc):
        _local.real = self._prev


def _real_of(x: torch.Tensor) -> Optional[int]:
    """The real samples of x's batch under bn_real_batch, None when all."""
    k = getattr(_local, "real", (None, None))[0]
    return None if k is None or k >= x.shape[0] else int(k)


def _real_total() -> Optional[int]:
    """The real samples over the ranks under bn_real_batch, or None."""
    return getattr(_local, "real", (None, None))[1]


class _Frame:
    """What one remat call records in its forward, in call order: each
    train-mode BatchNorm's statistics and each Dropout's generator state;
    and the real batch and the row mesh it ran under."""

    def __init__(self):
        self.stats, self.rng, self.real, self.rows = [], [], None, None


class _FrameScope:
    """The forward (`recompute` False) or the recompute context of one
    remat call (torch.utils.checkpoint's context_fn)."""

    def __init__(self, frame: _Frame, recompute: bool):
        self.frame, self.recompute = frame, recompute

    def __enter__(self):
        if _scope() is not None:
            raise RuntimeError("remat: regions do not nest")
        self._prev = getattr(_local, "real", (None, None))
        self._prev_rows = halo.state()
        if self.recompute:
            _local.real = self.frame.real
            halo.set_state(self.frame.rows)
        else:
            self.frame.real, self.frame.rows = self._prev, self._prev_rows
        self.n_stats = self.n_rng = 0
        _local.scope = self

    def __exit__(self, *exc):
        _local.scope, _local.real = None, self._prev
        halo.set_state(self._prev_rows)

    def next_stats(self) -> torch.Tensor:
        self.n_stats += 1
        return self.frame.stats[self.n_stats - 1]

    def next_rng(self):
        self.n_rng += 1
        return self.frame.rng[self.n_rng - 1]


def _scope() -> Optional[_FrameScope]:
    return getattr(_local, "scope", None)


def remat(fn, *args):
    """fn(*args), its saved activations dropped in the forward and
    recomputed in the backward (torch.utils.checkpoint, non-reentrant), as
    the JAX package's nn.remat; fn(*args) itself when no gradient is being
    recorded.  The recompute reuses each BatchNorm's statistics and each
    Dropout's generator state from the forward (module docstring)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    frame = _Frame()
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (_FrameScope(frame, False),
                                          _FrameScope(frame, True)))


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class Conv2d(nn.Conv2d):
    """nn.Conv2d's parameters with the JAX package's Conv2d forward.

    `s2d`: a dense 4x4 or 3x3 stride-2 padding-1 conv runs through
    space-to-depth (ops/s2d.py) on an even H and W, and as the direct conv
    otherwise (odd sizes such as 513x513), the JAX package's dispatch
    (s2r_tpu/models/layers.py:155-183).  The parameters are the same."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = False, s2d: bool = False):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups,
                         bias=bias)
        self.s2d = bool(s2d)

    @property
    def dw_stride1_3x3(self) -> bool:
        """A stride-1 3x3 depthwise conv padded by its dilation: the kernel's
        function."""
        return (self.groups == self.in_channels == self.out_channels
                and self.kernel_size == (3, 3) and self.stride == (1, 1)
                and self.padding == self.dilation
                and self.dilation[0] == self.dilation[1])

    def forward(self, x, fill: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N,C,H,W] -> [N,O,H',W'] in x's dtype.  `fill` ([C] float32,
        depthwise only): convolve as if the padding ring held `fill`.  A
        tuple or list x is convolved as the channel-concat of its parts
        (``_split_forward``)."""
        if isinstance(x, (tuple, list)):
            if fill is not None:
                raise ValueError("a split-concat conv takes no fill")
            return self._split_forward(tuple(x))
        w = self.weight.to(x.dtype)
        if fill is not None:
            if self.groups != self.in_channels or self.out_channels != self.in_channels:
                raise ValueError("fill is only defined for depthwise convs")
            x = x - _col(fill.to(x.dtype))
        sharded = halo.current() is not None
        if self.dw_stride1_3x3:
            d = self.dilation[0]
            xh = halo.halo(x, d) if sharded else x
            y = DepthwiseConv3x3.apply(
                xh.permute(0, 2, 3, 1).contiguous(),
                w[:, 0].permute(1, 2, 0).contiguous(), d)
            if sharded:  # the halo rows' outputs
                y = y[:, d:d + x.shape[2]].contiguous()
            y = y.permute(0, 3, 1, 2)
        elif self.s2d and s2d_applies(self, x):
            lower = (conv4x4s2_via_s2d if self.kernel_size == (4, 4)
                     else conv3x3s2_via_s2d)
            y = s2d_rows(lower, x, w) if sharded else lower(x, w)
        else:
            y = self._conv(x, lambda r: F.conv2d(
                r, w, None, self.stride, self._padding(), self.dilation,
                self.groups))
        if fill is not None:
            ksum = self.weight.sum(dim=(1, 2, 3))  # [C], float32
            y = y + _col((fill * ksum).to(y.dtype))
        if self.bias is not None:
            y = y + _col(self.bias.to(y.dtype))
        return y

    def _conv(self, x: torch.Tensor, op) -> torch.Tensor:
        """op(x), or under row sharding op on the rows this rank's output
        rows read (ops/halo.py ``conv_rows``)."""
        if halo.current() is None:
            return op(x)
        return halo.conv_rows(op, x, self.kernel_size[0], self.stride[0],
                              self.padding[0], self.dilation[0])

    def _padding(self):
        """The conv's padding; under row sharding none along H (the rows
        outside the image come in through ``_conv``)."""
        if halo.current() is None:
            return self.padding
        return (0, self.padding[1])

    def _split_forward(self, parts) -> torch.Tensor:
        """conv(concat(parts, channels)) as the sum over parts of conv(part,
        the kernel's slice of its input channels): the concat is never
        built (s2r_tpu/models/layers.py:95-150).  The parameter keeps the
        full concat shape, so checkpoints do not change.  A part of
        spatial size [1, 1] broadcasts into the sum, under a 1x1 kernel
        without padding only: ASPP's global-pool branch is convolved once
        at [N, C, 1, 1].  Dense convs only (groups 1).

        Two differences from the JAX package, which keeps them as faults
        (ROADMAP C.7): a [1, 1] part under nonzero padding raises a ValueError
        (there it is let through, and the padded ring would hold the
        broadcast value where the concat holds zeros), and the parts are
        summed in float32 and cast to the compute dtype once (there each
        part's sum is rounded to the compute dtype, so under bf16 the
        split differs from the concat by more than the order of the
        sums).  Each part's conv is rounded to the compute dtype by the
        conv itself, as the concat conv's output is."""
        if self.groups != 1:
            raise ValueError("a split-concat conv must be dense (groups 1)")
        if not parts:
            raise ValueError("a split-concat conv needs at least one part")
        dtype = parts[0].dtype
        # the widest part is full-size (a band may hold no rows)
        full = max((tuple(p.shape[2:]) for p in parts),
                   key=lambda hw: (hw[1], hw[0]))
        widths = [int(p.shape[1]) for p in parts]
        if sum(widths) != self.in_channels:
            raise ValueError(f"split parts of {widths} channels: the conv "
                             f"takes {self.in_channels}")
        acc = torch.promote_types(dtype, torch.float32)
        w = self.weight.to(dtype)
        outs, off = [], 0
        for p, c in zip(parts, widths):
            hw = tuple(p.shape[2:])
            if p.dtype != dtype:
                raise ValueError("split parts must share one dtype")
            if hw == (1, 1) and full != (1, 1):
                if self.kernel_size != (1, 1) or self.padding != (0, 0):
                    raise ValueError(
                        "a [1,1] split part broadcasts only under a 1x1 "
                        f"kernel without padding; this conv has kernel "
                        f"{self.kernel_size} and padding {self.padding}")
                outs.append(F.conv2d(p, w[:, off:off + c], None,
                                     self.stride, self.padding,
                                     self.dilation))
            elif hw != full:
                raise ValueError(f"split part of spatial size {hw}: want "
                                 f"{full} (or [1,1] under a 1x1 kernel)")
            else:  # a full-size part: under row sharding, its rows
                outs.append(self._conv(p, lambda r, k=w[:, off:off + c]:
                                       F.conv2d(r, k, None, self.stride,
                                                self._padding(),
                                                self.dilation)))
            off += c
        # the sum in float32, started from a full-size part, each other
        # part added in place (no float32 copy of it)
        first = max(range(len(outs)),
                    key=lambda i: (outs[i].shape[3], outs[i].shape[2]))
        y = outs[first].to(acc)
        for i, part in enumerate(outs):
            if i != first:
                y.add_(part)
        if self.bias is not None:
            y.add_(_col(self.bias.to(acc)))
        return y.to(dtype)


def s2d_rows(lower, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A space-to-depth lowering (ops/s2d.py) of a stride-2 padding-1 conv
    on row-sharded x: on the band plus 2 rows a side (an even offset, so
    the s2d pairs are the unsharded ones), the first and the last output
    row dropped.  The global height is even (``s2d_applies``), so a short
    band is too, and an empty one keeps no row."""
    y = lower(halo.halo(x, 2), w)[:, :, 1:-1]
    halo.register_strided(y, x, w.shape[2], 2, 1)
    return y


def s2d_applies(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether `conv` on x has a space-to-depth form (ops/s2d.py): dense,
    4x4 or 3x3, stride 2, padding 1, dilation 1, on an even H and W (the
    global H under row sharding)."""
    height = (x.shape[2] if halo.current() is None
              else halo.level(x)[0])
    return (conv.kernel_size in ((4, 4), (3, 3)) and conv.stride == (2, 2)
            and conv.padding == (1, 1) and conv.dilation == (1, 1)
            and conv.groups == 1 and height % 2 == 0
            and x.shape[3] % 2 == 0)


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and buffers with the JAX package's
    forward: running statistics in eval, batch statistics in train mode.
    ``sync`` (core/mesh.py Mesh, set by ``set_batchnorm_sync``) makes the
    train-mode statistics those of every rank's batch; None, or a mesh of
    one process, keeps them this batch's, on the fused entries."""

    sync = None

    def forward(self, x: torch.Tensor, ring: bool = False,
                zero_pad_width: int = 0):
        """x [N,C,H,W] -> y, or (y, shift) when `ring`: shift [C] float32 is
        what a zero padding ring around the BN input becomes.

        In train mode the statistics are taken as if x were zero-padded by
        `zero_pad_width` on both spatial sides (s2r_tpu/models/layers.py
        :330-336): the sums are unchanged and the count is N*(H+2d)*(W+2d).
        The running mean and the unbiased running variance over that count
        are updated in place with momentum 0.1 (:341-349).  Under
        bn_real_batch(k), over the first k samples only; in a remat
        recompute, the forward's statistics are reused and nothing is
        updated (module docstring).  Under row sharding (ops/halo.py) x
        is a band of the global image's rows, of its level's global
        height: the count and the ring are the global image's; in its
        ``replicated`` regions the statistics are synchronized over the
        ranks holding other samples only."""
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            shift = self.bias - self.running_mean * inv
            y = x * _col(inv.to(x.dtype)) + _col(shift.to(x.dtype))
            return (y, shift) if ring else y
        rows = halo.state()
        sync = rows.columns if rows.replicated else self.sync
        if sync is not None and sync.size == 1:
            sync = None
        scope = _scope()
        stats_in = stats_out = None
        if scope is not None and scope.recompute:
            stats_in = scope.next_stats()
        elif scope is not None:
            stats_out = scope.frame.stats
        sharded = rows.rows is not None
        y, shift, _, _ = BatchNormTrain.apply(
            x, self.weight, self.bias, self.eps, int(zero_pad_width),
            self.running_mean, self.running_var, float(self.momentum), sync,
            _real_of(x), stats_in, stats_out,
            rows.rows.size if sharded else 1,
            halo.level(x)[0] if sharded else None, _real_total())
        if stats_in is None:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
        return (y, shift) if ring else y


class Dropout(nn.Module):
    """Elementwise dropout (the reference's nn.Dropout): in train mode each
    element is kept with probability 1 - rate and scaled by 1/(1 - rate),
    the mask drawn from `generator` (the device's default generator when
    None); the gradient passes through the kept elements only.  The
    identity in eval, and while `enabled` is False (``set_dropout``).
    Under bn_real_batch(k) the mask of the first k samples is drawn at
    [k, ...] and the other samples are dropped; in a remat recompute the
    forward's draw is replayed (module docstring)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.enabled = True

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not (self.training and self.enabled) or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        k = _real_of(x)
        shape = x.shape if k is None else (k,) + tuple(x.shape[1:])
        if generator is None:
            generator = (torch.default_generator if x.device.type == "cpu"
                         else torch.cuda.default_generators[x.device.index])
        scope = _scope()
        if scope is not None and scope.recompute:
            generator = torch.Generator(device=x.device)
            generator.set_state(scope.next_rng())
        elif scope is not None:
            scope.frame.rng.append(generator.get_state())
        mask = self._draw(shape, x.device, generator, keep)
        if k is not None:
            mask = torch.cat([mask, mask.new_zeros((x.shape[0] - k,)
                                                   + tuple(x.shape[1:]))])
        return torch.where(mask, x / keep, x.new_zeros(()))

    @staticmethod
    def _draw(shape, device, generator, keep: float) -> torch.Tensor:
        """The boolean keep-mask of `shape`, drawn from `generator`."""
        return torch.rand(shape, device=device, generator=generator) < keep


def set_dropout(module: nn.Module, enabled: bool) -> None:
    """Switch every Dropout under `module` on or off (off: the identity
    also in train mode, for runs that must be deterministic)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.enabled = bool(enabled)


def set_batchnorm_sync(module: nn.Module, mesh) -> None:
    """Synchronize the train-mode statistics of every BatchNorm under
    `module` over `mesh` (core/mesh.py; None or one process: off)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync = mesh


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
