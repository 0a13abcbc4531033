"""Uneven bands and padded batches under a mesh (--spatial-shard and
--eval-spatial-shard at any crop, pad_to under any layout): the port
against the whole tensor and the JAX package, on the CPU, ranks simulated
by threads (an all-reduce and an all-gather over shared memory).

The band rule (core/mesh.py ``band_rows``): H rows over S ranks at the
path's largest stride u are cut into bands of ceil(H/(S*u))*u rows, so
the last band or bands are short or empty.

- ``gather_rows`` at S 2, 3 and 4 over 65, 72, 97 and 33 rows (short
  and empty bands), zero and -inf pads, float64: values and gradients
  equal to slicing the whole padded tensor.
- Each layer kind over uneven bands equals it on the whole tensor,
  forward and backward, float64, rel 1e-12: dense 3x3 at dilations
  1/6/12/18, stride 2 (3x3, 1x1, ResNet's 7x7 stem) with an empty
  output band, depthwise with the ``fill`` ring, the s2d lowerings, the
  discriminator stack (its empty bands), both align-corners resizes,
  ASPP, ResNet's max pool, and BatchNorm with its ring count.
- DeepLab's train forward and backward with D on its softmax, 65 rows
  over 2 bands (64 and 1; D's later bands empty), against the whole
  image, float64, rel 1e-10; ResNet-50, Xception-65 and DRN-D-54's
  forward and input gradient likewise.
- The MobileNetV2 eval step over 2 and 3 ranks at 65 rows against the
  JAX package's unsharded eval step (tests/test_spatial_shard.py's
  bounds: loss rtol 1e-5, confusion matrix equal, labels > 0.999 equal).
- The padded output step (pad_to 8 over a real batch of 4, the pad
  samples on the last data rank) over 2 data ranks and over 2 x 2 ranks
  at 33 rows (bands 32 and 1), float64, against the JAX package's padded
  step on one device: tests/test_batch_pad.py:183's and
  tests/test_spatial_train.py:115's bounds, and
  tests/test_torch_port_train_step_f64.py's.
"""

import copy
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2r_tpu_torch.core.mesh import Layout, Mesh, band_bounds, band_rows
from s2r_tpu_torch.models.aspp import ASPP
from s2r_tpu_torch.models.discriminator import FCDiscriminator
from s2r_tpu_torch.models.layers import (BatchNorm, Conv2d, set_batchnorm_sync,
                                         set_dropout)
from s2r_tpu_torch.models.resnet import max_pool_3x3_s2
from s2r_tpu_torch.ops import halo
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners

from _torch_port_common import (check_port_step, jax_deeplab,
                                jax_f64_output_step, port_deeplab,
                                torch_threads)

F64 = torch.float64


class _Shared:
    def __init__(self, size):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class _ThreadMesh(Mesh):
    """Rank `rank` of `size` threads: core/mesh.py Mesh with its
    all-reduce and all-gather over shared memory."""

    def __init__(self, shared, size, rank):
        super().__init__(size, rank)
        self.shared = shared

    def _exchange(self, t):
        self.shared.slots[self.rank] = t.detach().clone()
        self.shared.barrier.wait()
        out = list(self.shared.slots)
        self.shared.barrier.wait()
        return out

    def all_reduce_(self, t, op="sum"):
        stack = torch.stack(self._exchange(t))
        with torch.no_grad():
            t.copy_(stack.sum(0) if op == "sum" else stack.amax(0))
        self._count(t)
        return t

    def all_gather(self, t):
        self.gathers += 1
        self.gathered += t.numel()
        return self._exchange(t.contiguous())


def _threads(world, spatial, fn):
    """fn(layout, rank) on `world` threads laid out as data rows x
    `spatial` columns; their results by rank."""
    rows = world // spatial
    shared = [_Shared(world)] + [_Shared(spatial) for _ in range(rows)] \
        + [_Shared(rows) for _ in range(spatial)]
    out, errors = [None] * world, []

    def layout(r):
        wm = _ThreadMesh(shared[0], world, r)
        d, s = divmod(r, spatial)
        space = (Mesh() if spatial == 1 else wm if spatial == world
                 else _ThreadMesh(shared[1 + d], spatial, s))
        data = (wm if spatial == 1 else Mesh() if rows == 1
                else _ThreadMesh(shared[1 + rows + s], rows, d))
        return Layout(wm, space, data, spatial)

    def run(r):
        try:
            with torch_threads():
                out[r] = fn(layout(r), r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            for s in shared:
                s.barrier.abort()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return out


def _rel(a, b):
    a, b = a.double(), b.double()
    den = float(b.abs().max())
    return float((a - b).abs().max()) / (den if den else 1.0)


def _x(n, c, h, w, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, c, h, w))


def _row_start(y, space):
    """The first global row of this rank's band of y: its bands lie in
    rank order, so the rows of the ranks before it."""
    counts = space.all_gather(torch.tensor([y.shape[2]]))
    return int(sum(int(c) for c in counts[:space.rank]))


def _banded(fn, x, params, spatial, unit=1, world=None, mods=None,
            bind=None):
    """fn(x band, module) on `world` (default `spatial`) thread ranks, data
    rows x `spatial` bands by the band rule at `unit`, under row_shard
    with the global height: (y, x's gradient, each of params(module)'s
    gradients summed over the ranks, u) of the loss sum(y * u), u fixed.
    `mods(r)`: rank r's module (None: no module), `bind(layout, module)`
    run before its forward."""
    world = world or spatial
    rows = world // spatial
    h, w = x.shape[2], x.shape[3]
    band = band_rows(h, spatial, unit)
    probe = copy.deepcopy(mods(0)) if mods else None
    with torch.no_grad():
        y_full = fn(x.detach(), probe)
    u = torch.from_numpy(np.random.RandomState(9).randn(*y_full.shape))
    u = u.to(y_full.dtype)

    def rank(layout, r):
        d, s = layout.data.rank, layout.space.rank
        mod = mods(r) if mods else None
        if bind:
            bind(layout, mod)
        r0, r1 = band_bounds(h, band, s)
        xb = x[d::rows, :, r0:r1].detach().clone().requires_grad_(True)
        with halo.row_shard(layout.space, h, unit, layout.data, w):
            y = fn(xb, mod)
        o0 = _row_start(y, layout.space)
        grads = torch.autograd.grad(
            (y * u[d::rows, :, o0:o0 + y.shape[2]]).sum(),
            [xb] + list(params(mod)), allow_unused=True)
        return y.detach(), grads, (r0, o0)

    out = _threads(world, spatial, rank)
    y = torch.empty_like(y_full)
    gx = torch.empty_like(x)
    for r, (yr, g, (r0, o0)) in enumerate(out):
        d = r // spatial
        y[d::rows, :, o0:o0 + yr.shape[2]] = yr
        gx[d::rows, :, r0:r0 + g[0].shape[2]] = g[0]
    gp = [sum(o[1][i] for o in out if o[1][i] is not None)
          for i in range(1, len(out[0][1]))]
    return y, gx, gp, u


def _whole(fn, x, params, u):
    xw = x.detach().clone().requires_grad_(True)
    y = fn(xw)
    grads = torch.autograd.grad((y * u).sum(), [xw] + list(params),
                                allow_unused=True)
    return y.detach(), grads[0], list(grads[1:])


def _check_layer(fn, x, params=(), spatial=2, unit=1, tol=1e-12):
    y, gx, gp, u = _banded(lambda t, _: fn(t), x, lambda _: params, spatial,
                           unit)
    wy, wgx, wgp = _whole(fn, x, params, u)
    assert _rel(y, wy) <= tol, _rel(y, wy)
    assert _rel(gx, wgx) <= tol, _rel(gx, wgx)
    for a, b in zip(gp, wgp):
        assert _rel(a, b) <= tol, _rel(a, b)


def _conv(cin, cout, k, stride=1, padding=0, dilation=1, groups=1, seed=0,
          s2d=False):
    conv = Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=True, s2d=s2d)
    conv.double()
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g,
                                      dtype=F64))
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=g, dtype=F64))
    return conv


# (S, H, unit): bands of 64 and 1; 32, 32, 8; 32, 32, 32, 1; 16, 16, 1;
# and 32, 32, 1 and an empty one
GATHER_CASES = [(2, 65, 32), (3, 72, 32), (4, 97, 32), (3, 33, 16),
                (4, 65, 32)]


@pytest.mark.parametrize("spatial,height,unit", GATHER_CASES)
@pytest.mark.parametrize("pad", [0.0, float("-inf")])
def test_gather_rows_short_and_empty_bands(spatial, height, unit, pad):
    """Rows [r0 - above, r0 + band + below) of each rank (its band's start
    r0, short or empty bands read past the image) equal the slice of the
    whole padded tensor; each gathered row's gradient returns to its
    owner."""
    band = band_rows(height, spatial, unit)
    x = _x(2, 3, height, 4)
    cases = [(1, 1), (2, 0), (0, 3), (band + 1, 2 * band + 1), (-1, 2),
             (1, -1)]

    def run(layout, r):
        mesh = layout.space
        r0, r1 = band_bounds(height, band, mesh.rank)
        out = []
        for above, below in cases:
            xb = x[:, :, r0:r1].clone().requires_grad_(True)
            y = halo.gather_rows(xb, r0 - above, r0 + band + below, mesh,
                                 pad, (height, band))
            wt = torch.arange(y.numel(), dtype=F64).view(y.shape) + r
            (gx,) = torch.autograd.grad((torch.where(torch.isinf(y), 0, y)
                                         * wt).sum(), xb)
            out.append((y.detach(), wt, gx))
        return out

    out = _threads(spatial, spatial, run)
    big = 3 * band + 2
    xp = torch.cat([torch.full((2, 3, big, 4), pad, dtype=F64), x,
                    torch.full((2, 3, big, 4), pad, dtype=F64)], dim=2)
    for i, (above, below) in enumerate(cases):
        gx = torch.zeros_like(x)
        for s in range(spatial):
            y, wt, _ = out[s][i]
            lo = big + band_bounds(height, band, s)[0] - above
            assert torch.equal(y, xp[:, :, lo:lo + band + above + below]), \
                (above, below, s)
            gp = torch.zeros_like(xp)
            gp[:, :, lo:lo + y.shape[2]] = wt
            gx += gp[:, :, big:big + height]
        got = torch.cat([out[s][i][2] for s in range(spatial)], dim=2)
        assert torch.equal(got, gx), (above, below)


@pytest.mark.parametrize("dilation", [1, 6, 12, 18])
def test_dense_conv3x3_dilated(dilation):
    """13 rows over 4: bands of 4, 4, 4 and 1."""
    conv = _conv(3, 4, 3, padding=dilation, dilation=dilation)
    _check_layer(conv, _x(2, 3, 13, 5), [conv.weight, conv.bias], spatial=4)


@pytest.mark.parametrize("k,stride,padding", [(3, 2, 1), (1, 2, 0),
                                              (7, 2, 3)])
def test_dense_conv_strided(k, stride, padding):
    """17 rows over 4 at stride 2: bands of 6, 6, 5 and none."""
    conv = _conv(3, 4, k, stride=stride, padding=padding)
    _check_layer(conv, _x(2, 3, 17, 6), [conv.weight, conv.bias], spatial=4,
                 unit=2)


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_depthwise_with_fill(dilation):
    """The stride-1 depthwise conv (the kernel wrapper's plain route on
    the CPU) on a short band plus its halo, with the ``fill`` ring, and a
    stride-2 depthwise conv with fill (F.conv2d), 17 rows over 3."""
    conv = _conv(5, 5, 3, padding=dilation, dilation=dilation, groups=5)
    assert conv.dw_stride1_3x3
    fill = torch.from_numpy(np.random.RandomState(3).rand(5)).requires_grad_(
        True)
    _check_layer(lambda x: conv(x, fill=fill), _x(2, 5, 17, 7),
                 [conv.weight, fill], spatial=3, unit=2)
    conv2 = _conv(5, 5, 3, stride=2, padding=1, groups=5)
    _check_layer(lambda x: conv2(x, fill=fill), _x(2, 5, 17, 7),
                 [conv2.weight, fill], spatial=3, unit=2)


@pytest.mark.parametrize("k", [4, 3])
@pytest.mark.parametrize("height,spatial", [(40, 3), (72, 4)])
def test_s2d_lowerings(k, height, spatial):
    """The s2d forms on an even global height: 40 rows over 3 at unit 8
    (bands 16, 16, 8) and 72 over 4 (24, 24, 24 and none)."""
    conv = _conv(3, 4, k, stride=2, padding=1, s2d=True)
    _check_layer(conv, _x(2, 3, height, 8), [conv.weight], spatial=spatial,
                 unit=8)


@pytest.mark.parametrize("s2d_convs", [0, 3])
def test_discriminator_stack(s2d_convs):
    """65 rows over 2 at stride 32: the map's bands are 64 and 1, D's
    levels (floor(H/2)) 32, 16, 8, 4, 2 all in the first band."""
    d = FCDiscriminator(num_classes=19, ndf=8, dtype=F64, device="cpu",
                        s2d_convs=s2d_convs).double()
    x = torch.softmax(_x(2, 19, 65, 34), dim=1)
    _check_layer(d, x, list(d.parameters()), unit=32)


def test_align_corners_resizes():
    """The decoder's resize (stride 4 to the stride-2 level: 9 -> 17
    rows) and the logits' upsample (stride 4 to the input: 9 -> 33), the
    levels made by two stride-2 convs; 33 rows over 3 at unit 4: bands of
    12, 12 and 9."""
    c1 = _conv(3, 3, 3, stride=2, padding=1, seed=1)
    c2 = _conv(3, 3, 3, stride=2, padding=1, seed=2)

    def decoder(x):
        a = c1(x)
        return resize_bilinear_align_corners(c2(a), a.shape[-2:])

    def logits(x):
        return resize_bilinear_align_corners(c2(c1(x)), x.shape[-2:])

    for fn in (decoder, logits):
        _check_layer(fn, _x(2, 3, 33, 6), [c1.weight, c2.weight], spatial=3,
                     unit=4)


def test_resnet_max_pool():
    """17 rows over 4 at stride 2: bands of 6, 6, 5 and none."""
    x = torch.relu(_x(2, 3, 17, 7))
    _check_layer(max_pool_3x3_s2, x, spatial=4, unit=2)


def _aspp(train):
    torch.manual_seed(0)
    aspp = ASPP(16, inplanes=6).double()
    for m in aspp.modules():
        if isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.1)
    aspp.train(train)
    aspp.dropout.enabled = False
    return aspp


def _sync(layout, mod):
    set_batchnorm_sync(mod, layout.world)


@pytest.mark.parametrize("world,spatial", [(2, 2), (3, 3), (4, 2)])
@pytest.mark.parametrize("train", [False, True])
def test_aspp(train, world, spatial):
    """ASPP at os 16 (dilations up to 18 past bands of 3 or 4 rows) over 7
    rows: 4 and 3 over 2 bands, 3, 3 and 1 over 3; the pool over the
    'space' group divides by the global area; in train mode BatchNorm
    synchronized over the world (the pooled branch's over the 'data'
    group)."""
    aspp = _aspp(train)
    copies = [copy.deepcopy(aspp) for _ in range(world)]
    x = _x(4, 6, 7, 5)
    y, gx, gp, u = _banded(lambda t, m: m(t), x,
                           lambda m: list(m.parameters()), spatial,
                           world=world, mods=copies.__getitem__, bind=_sync)
    wy, wgx, wgp = _whole(aspp, x, list(aspp.parameters()), u)
    assert _rel(y, wy) <= 1e-12 and _rel(gx, wgx) <= 1e-12
    for a, b in zip(gp, wgp):
        assert _rel(a, b) <= 1e-12
    for c in copies:
        for got, want in zip(c.buffers(), aspp.buffers()):
            assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("world,spatial,height", [(2, 2, 9), (3, 3, 7),
                                                  (4, 2, 9)])
def test_batchnorm_ring_count(world, spatial, height):
    """BatchNorm with a zero ring (zero_pad_width 2) on uneven bands (9
    rows: 5 and 4; 7 over 3: 3, 3 and 1), synchronized over the world: y,
    shift, the running statistics, dx and the summed dweight and dbias
    equal the whole batch's.  The count is the global image's ring over
    its real rows, whatever the bands hold."""
    bn = BatchNorm(3).double().train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0, 0.1)
    ush = torch.from_numpy(np.random.RandomState(2).randn(3))
    copies = [copy.deepcopy(bn) for _ in range(world)]

    def fn(t, mod):
        y, shift = mod(t, ring=True, zero_pad_width=2)
        return y + (shift * ush).view(1, -1, 1, 1)  # shift's gradient too

    x = _x(4, 3, height, 5) + 0.3
    y, gx, gp, u = _banded(fn, x, lambda m: list(m.parameters()), spatial,
                           world=world, mods=copies.__getitem__, bind=_sync)
    wy, wgx, wgp = _whole(lambda t: fn(t, bn), x, list(bn.parameters()), u)
    assert _rel(y, wy) <= 1e-12
    assert _rel(gx, wgx) <= 1e-12
    for a, b in zip(gp, wgp):
        assert _rel(a, b) <= 1e-12
    for c in copies:
        assert torch.equal(c.running_var, copies[0].running_var)
        assert torch.equal(c.running_mean, copies[0].running_mean)
    assert _rel(copies[0].running_mean, bn.running_mean) <= 1e-12
    assert _rel(copies[0].running_var, bn.running_var) <= 1e-12


def test_deeplab_and_discriminator_65_rows():
    """DeepLab (MobileNetV2, train mode, BatchNorm synchronized over the
    bands) and D on its class softmax, 65 x 33 over 2 bands at stride 32
    (64 rows and 1; ASPP's level 4 and 1; D's later levels all in the
    first band, the second empty): the logits, D's output, and the
    gradients of the input and of every parameter of both equal the
    whole image's, float64, rel 1e-10."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.tools.step_conditioning import perturb_batchnorm

    model = DeepLab(dtype=F64, device="cpu",
                    generator=torch.Generator().manual_seed(1)).double()
    model.train()
    set_dropout(model, False)
    perturb_batchnorm(model, 1, affine_seed=2)  # off relu6's kink at fill
    d = FCDiscriminator(num_classes=19, ndf=8, dtype=F64, device="cpu",
                        generator=torch.Generator().manual_seed(2)).double()
    pair = torch.nn.ModuleList([model, d])
    copies = [copy.deepcopy(pair) for _ in range(2)]

    def fn(t, mods):
        logits = mods[0](t)[0]
        return logits, mods[1](torch.softmax(logits, dim=1))

    x = _x(1, 3, 65, 33, seed=3)
    with torch_threads():
        wl, wd = fn(x, pair)
    ul = torch.from_numpy(np.random.RandomState(5).randn(*wl.shape))
    ud = torch.from_numpy(np.random.RandomState(6).randn(*wd.shape))
    params = list(pair.parameters())

    def rank(layout, r):
        mods = copies[r]
        set_batchnorm_sync(mods[0], layout.world)
        band = band_rows(65, 2, 32)
        r0, r1 = band_bounds(65, band, r)
        xb = x[:, :, r0:r1].clone().requires_grad_(True)
        with halo.row_shard(layout.space, 65, 32, layout.data, 33):
            logits, out = fn(xb, mods)
        o0, q0 = _row_start(logits, layout.space), _row_start(
            out, layout.space)
        loss = ((logits * ul[:, :, o0:o0 + logits.shape[2]]).sum()
                + (out * ud[:, :, q0:q0 + out.shape[2]]).sum())
        grads = torch.autograd.grad(loss, [xb] + list(mods.parameters()))
        return logits.detach(), out.detach(), grads

    out = _threads(2, 2, rank)
    assert [o[1].shape[2] for o in out] == [2, 0]  # D's empty band
    assert [o[0].shape[2] for o in out] == [64, 1]
    xw = x.clone().requires_grad_(True)
    with torch_threads():
        lw, dw = fn(xw, pair)
        wg = torch.autograd.grad((lw * ul).sum() + (dw * ud).sum(),
                                 [xw] + params)
    assert _rel(torch.cat([o[0] for o in out], 2), wl.detach()) <= 1e-10
    assert _rel(torch.cat([o[1] for o in out], 2), wd.detach()) <= 1e-10
    assert _rel(torch.cat([o[2][0] for o in out], 2), wg[0]) <= 1e-10
    for i, want in enumerate(wg[1:]):
        parts = [o[2][i + 1] for o in out]
        scale = max(float(t.abs().max()) for t in parts + [want])
        assert float((sum(parts) - want).abs().max()) <= 1e-10 * scale, i


EVAL_HW = 65


@functools.lru_cache(maxsize=None)
def _jax_eval():
    """(params, stats, image, label, the JAX package's unsharded eval step
    on them) at 65 x 65, made once."""
    from s2r_tpu.train.losses import build_seg_loss as jax_loss
    from s2r_tpu.train.steps import make_eval_step as jax_eval_step

    model, params, stats = jax_deeplab(EVAL_HW)
    rs = np.random.RandomState(1)
    image = rs.randn(1, EVAL_HW, EVAL_HW, 3).astype(np.float32)
    label = rs.randint(0, 19, (1, EVAL_HW, EVAL_HW)).astype(np.int32)
    out = jax.jit(jax_eval_step(model, jax_loss("ce"), 19))(
        params, stats, jnp.asarray(image), jnp.asarray(label))
    return params, stats, image, label, out


@pytest.mark.parametrize("backbone", ["resnet50", "xception", "drn"])
def test_other_backbones_uneven(backbone):
    """The other backbones' train forward and its input gradient, 65 x 33
    over 2 bands at their row stride (48 and 17 rows; DRN at 8: 40 and
    25), BatchNorm synchronized over the bands, against the whole image,
    float64, rel 1e-10."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.tools.step_conditioning import perturb_batchnorm

    model = DeepLab(backbone=backbone, dtype=F64, device="cpu",
                    generator=torch.Generator().manual_seed(1)).double()
    model.train()
    set_dropout(model, False)
    perturb_batchnorm(model, 1, affine_seed=2)
    copies = [copy.deepcopy(model) for _ in range(2)]
    x = _x(1, 3, 65, 33, seed=3)
    y, gx, _, u = _banded(lambda t, m: m(t)[0], x, lambda m: [], 2,
                          model.row_stride, mods=copies.__getitem__,
                          bind=_sync)
    with torch_threads():
        wy, wgx, _ = _whole(lambda t: model(t)[0], x, [], u)
    assert _rel(y, wy) <= 1e-10 and _rel(gx, wgx) <= 1e-10


@pytest.mark.parametrize("spatial", [2, 3])
def test_mobilenet_eval_step_matches_jax(spatial):
    """The port's eval step over 2 and 3 thread ranks at 65 rows (bands of
    48 and 17; 32, 32 and 1) on the JAX weights, the batch banded by
    core/mesh.py Layout.band, against the JAX package's unsharded eval
    step (tests/test_spatial_shard.py's bounds)."""
    from s2r_tpu_torch.train.losses import build_seg_loss
    from s2r_tpu_torch.train.steps import make_eval_step

    hw, c = EVAL_HW, 19
    params, stats, image, label, (j_loss, j_cm, j_pred) = _jax_eval()
    port = [port_deeplab(params, stats) for _ in range(spatial)]

    def run(layout, r):
        step = make_eval_step(port[r], build_seg_loss("ce",
                                                      mesh=layout.world),
                              c, layout.world)
        layout.unit = port[r].row_stride
        b = layout.band({"image": torch.from_numpy(image),
                         "label": torch.from_numpy(label)}, eval_rows=True)
        return step(b["image"], b["label"], b["height"])

    out = _threads(spatial, spatial, run)
    assert sum(o[2].shape[1] for o in out) == hw
    loss = sum(float(o[0]) for o in out)
    cm = sum(o[1] for o in out)
    pred = torch.cat([o[2] for o in out], dim=1)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(j_cm))
    agree = float((pred.numpy() == np.asarray(j_pred)).mean())
    assert agree > 0.999, agree


PAD_HW, PAD_K, PAD_TO = 33, 4, 8
_tls = threading.local()


def _pad_batch():
    rs = np.random.RandomState(11)
    lbl = rs.randint(0, 19, (PAD_K, PAD_HW, PAD_HW)).astype(np.int32)
    lbl[:, :3] = 255
    return {"src_image": rs.randn(PAD_K, PAD_HW, PAD_HW, 3).astype(
                np.float32),
            "src_label": lbl,
            "tgt_image": rs.randn(PAD_K, PAD_HW, PAD_HW, 3).astype(
                np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_padded_step():
    """The JAX package's padded output step (pad_to 8 over 4 real samples)
    on one device, float64 (_torch_port_common.jax_f64_output_step)."""
    return jax_f64_output_step(_pad_batch(), PAD_HW, PAD_K, pad_to=PAD_TO)


@pytest.mark.parametrize("world,spatial", [(2, 1), (4, 2)],
                         ids=["2_data_ranks", "2x2"])
def test_padded_output_step_matches_jax(world, spatial, monkeypatch):
    """pad_to 8 over a real batch of 4 on 2 data ranks: the first holds the
    4 real samples, the second none (JAX's global-index masks put the pad
    samples on the last shard); at 2 x 2 each data row's 2 ranks hold
    bands of 32 and 1 of its rows.  Against the JAX package's padded step
    on one device, float64: tests/test_batch_pad.py:183's bounds (metrics
    rtol 1e-4 atol 1e-5, running statistics rtol 1e-4 atol 1e-5,
    parameters atol 2e-3; tests/test_spatial_train.py:115's are these
    or looser) and tests/test_torch_port_train_step_f64.py's
    (check_port_step); every rank ends with the same state."""
    from s2r_tpu_torch.io.convert import from_jax_variables
    from s2r_tpu_torch.train import setup as S

    jax_step = _jax_padded_step()
    monkeypatch.setattr(S, "make_mesh", lambda n=None: _tls.layout.world)
    monkeypatch.setattr(S, "make_layout", lambda mesh, s=1: _tls.layout)
    monkeypatch.setattr(S, "_step_pad_to", lambda cfg, n: PAD_TO)
    batch = {k: torch.from_numpy(v) for k, v in _pad_batch().items()}

    def rank(layout, r):
        _tls.layout = layout
        layout.unit = 32  # the output step's band rule (steps.path_stride)
        per = PAD_TO // layout.data.size
        d = layout.data.rank
        share = layout.band({k: v[d * per:(d + 1) * per]
                             for k, v in batch.items()})
        from _torch_port_common import port_step_from_jax
        return port_step_from_jax(*jax_step[:3], 0, share, "f64",
                                  crop_size=PAD_HW, base_size=PAD_HW,
                                  batch_size=PAD_TO, spatial_shard=spatial)

    out = _threads(world, spatial, rank)
    for o in out[1:]:
        for k, v in o[1].items():
            assert torch.equal(v, out[0][1][k]), k
    check_port_step(jax_step, out[0])
    params, stats, _, after_params, after_stats, met = jax_step
    for k in met:
        np.testing.assert_allclose(out[0][0][k], met[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want = from_jax_variables(after_params["G"], after_stats)
    for k, w in want.items():
        if "num_batches" in k:
            continue
        got = out[0][1][k].numpy()
        if "running" in k:
            np.testing.assert_allclose(got, w.double().numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got, w.double().numpy(), rtol=0,
                                       atol=2e-3, err_msg=k)
