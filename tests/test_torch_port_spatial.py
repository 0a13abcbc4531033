"""The spatial arms of the port (--spatial-shard, --eval-spatial-shard):
row-sharded layers and their halo exchanges (ops/halo.py) against the
same layers on the whole tensor, on the CPU, ranks simulated by threads
(an all-reduce and an all-gather over shared memory).

- ``gather_rows`` at S in {2, 4}, float64: values and gradients equal to
  slicing the whole zero- or -inf-padded tensor, halos wider than a
  shard included.
- Each layer kind sharded equals it unsharded, forward and backward,
  float64, rel 1e-12: dense 3x3 at dilations 1/6/12/18, stride 2 (3x3,
  1x1, ResNet's 7x7 stem), depthwise with the ``fill`` ring (the plain
  route of the kernel wrapper), the s2d lowerings, the discriminator
  stack, both align-corners resizes, ASPP (its pool over the 'space'
  group), ResNet's max pool, and BatchNormTrain with a zero ring, whose
  count under the parent's rule (the band's ring times the world) moves
  the statistics.
- A 2 x 2 (data x space) layout: the batch-axis softmax over the 'data'
  group equals the whole batch's, and over the world it does not.
- The MobileNetV2 eval step sharded over 2 thread ranks against the JAX
  package's unsharded eval step on the same weights
  (tests/test_spatial_shard.py's bounds: loss rtol 1e-5, confusion
  matrix equal, labels > 0.999 equal).
- ResNet-50, Xception-65 and DRN-D-54: DeepLab's train-mode forward and
  backward over 2 bands against the whole image, float64, rel 1e-10.
- The refusals: S not dividing the world, a batch not dividing the data
  rows, a world spanning nodes; a height not divisible by S times the
  stride and batch padding under a spatial layout run
  (tests/test_torch_port_uneven.py holds them).

The steps at 2 x 2 over gloo processes run in
tests/test_torch_port_distributed.py's spawn.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2r_tpu_torch.core import mesh as M
from s2r_tpu_torch.core.mesh import Layout, Mesh
from s2r_tpu_torch.models.aspp import ASPP
from s2r_tpu_torch.models.discriminator import FCDiscriminator
from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, set_batchnorm_sync
from s2r_tpu_torch.models.resnet import max_pool_3x3_s2
from s2r_tpu_torch.ops import halo
from s2r_tpu_torch.ops.kernels import batchnorm as BN
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners
from s2r_tpu_torch.ops.s2d import conv3x3s2_via_s2d, conv4x4s2_via_s2d
from s2r_tpu_torch.train.steps import batch_softmax

from _torch_port_common import jax_deeplab, port_deeplab, torch_threads

F64 = torch.float64


class _Shared:
    def __init__(self, size):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class _ThreadMesh:
    """Rank `rank` of `size` threads: core/mesh.py Mesh's all-reduce and
    all-gather over shared memory."""

    def __init__(self, shared, size, rank):
        self.shared, self.size, self.rank = shared, size, rank
        self.calls = self.elements = self.gathers = self.gathered = 0

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
        self.calls += 1
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


def _band(x, s, size, dim=2):
    h = x.shape[dim] // size
    return x.narrow(dim, s * h, h)


def _sharded(fn, x, params, spatial, world=None, extra=None):
    """fn(x band) on `spatial` thread ranks under row_shard (and
    `extra(layout)` entered around it): the bands concatenated, x's
    gradient and each parameter's summed over the ranks, of the loss
    sum(y * u) with a fixed u."""
    world = world or spatial
    y_full = fn(x.detach())
    u = torch.from_numpy(np.random.RandomState(9).randn(*y_full.shape))
    u = u.to(y_full.dtype)

    def rank(layout, r):
        s = layout.space.rank
        xb = _band(x, s, spatial).detach().clone().requires_grad_(True)
        with halo.row_shard(layout.space, x.shape[2], width=x.shape[3]):
            y = fn(xb)
        grads = torch.autograd.grad((y * _band(u, s, spatial)).sum(),
                                    [xb] + list(params),
                                    allow_unused=True)
        return y.detach(), grads

    out = _threads(world, spatial, rank)
    y = torch.cat([o[0] for o in out[:spatial]], dim=2)
    gx = torch.cat([o[1][0] for o in out[:spatial]], dim=2)
    gp = [sum(o[1][i + 1] for o in out[:spatial]) for i in range(len(params))]
    return y, gx, gp, u


def _whole(fn, x, params, u):
    xw = x.detach().clone().requires_grad_(True)
    y = fn(xw)
    grads = torch.autograd.grad((y * u).sum(), [xw] + list(params),
                                allow_unused=True)
    return y.detach(), grads[0], list(grads[1:])


def _check_layer(fn, x, params=(), spatial=2, tol=1e-12):
    y, gx, gp, u = _sharded(fn, x, params, spatial)
    wy, wgx, wgp = _whole(fn, x, params, u)
    assert y.shape == wy.shape
    assert _rel(y, wy) <= tol, _rel(y, wy)
    assert _rel(gx, wgx) <= tol, _rel(gx, wgx)
    for a, b in zip(gp, wgp):
        assert _rel(a, b) <= tol, _rel(a, b)


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("pad", [0.0, float("-inf")])
def test_gather_rows_equals_slicing(spatial, pad):
    """Rows [r0 - above, r1 + below) of each rank equal the slice of the
    whole tensor padded by `pad`, for halos within a neighbour, across
    several ranks and past the image, and crops; the gradient of each
    gathered row returns to its owner."""
    rs = np.random.RandomState(0)
    h = 3
    x = torch.from_numpy(rs.randn(2, 3, h * spatial, 4))
    cases = [(1, 1), (2, 0), (0, 3), (h + 1, 2 * h + 1), (-1, 2), (1, -1)]

    def run(layout, r):
        mesh = layout.space
        out = []
        for above, below in cases:
            xb = _band(x, mesh.rank, spatial).clone().requires_grad_(True)
            r0 = mesh.rank * h
            y = halo.gather_rows(xb, r0 - above, r0 + h + below, mesh, pad,
                                 (h * spatial, h))
            w = torch.arange(y.numel(), dtype=F64).view(y.shape) + r
            (gx,) = torch.autograd.grad((torch.where(torch.isinf(y), 0, y)
                                         * w).sum(), xb)
            out.append((y.detach(), w, gx))
        return out

    out = _threads(spatial, spatial, run)
    for i, (above, below) in enumerate(cases):
        big = max(above, below, 0)
        xp = torch.cat([torch.full((2, 3, big, 4), pad, dtype=F64), x,
                        torch.full((2, 3, big, 4), pad, dtype=F64)], dim=2)
        gx = torch.zeros_like(x)
        for s in range(spatial):
            y, w, _ = out[s][i]
            lo = big + s * h - above
            want = xp[:, :, lo:lo + h + above + below]
            assert torch.equal(y, want), (spatial, above, below, s)
            gp = torch.zeros_like(xp)
            gp[:, :, lo:lo + y.shape[2]] = w
            gx += gp[:, :, big:big + x.shape[2]]
        got = torch.cat([out[s][i][2] for s in range(spatial)], dim=2)
        assert torch.equal(got, gx), (spatial, above, below)


def _conv(cin, cout, k, stride=1, padding=0, dilation=1, groups=1,
          seed=0, s2d=False):
    conv = Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=True, s2d=s2d)
    conv.double()
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g,
                                      dtype=F64))
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=g, dtype=F64))
    return conv


def _x(n, c, h, w, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, c, h, w))


@pytest.mark.parametrize("dilation", [1, 6, 12, 18])
def test_dense_conv3x3_dilated(dilation):
    conv = _conv(3, 4, 3, padding=dilation, dilation=dilation)
    _check_layer(conv, _x(2, 3, 16, 5), [conv.weight, conv.bias])


@pytest.mark.parametrize("k,stride,padding", [(3, 2, 1), (1, 2, 0),
                                              (7, 2, 3)])
def test_dense_conv_strided(k, stride, padding):
    conv = _conv(3, 4, k, stride=stride, padding=padding)
    _check_layer(conv, _x(2, 3, 16, 6), [conv.weight, conv.bias], spatial=4)


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_depthwise_with_fill(dilation):
    """The stride-1 depthwise conv (the kernel wrapper's plain route on
    the CPU) on the band plus its halo, with the ``fill`` ring, and a
    stride-2 depthwise conv with fill (F.conv2d)."""
    conv = _conv(5, 5, 3, padding=dilation, dilation=dilation, groups=5)
    assert conv.dw_stride1_3x3
    fill = torch.from_numpy(np.random.RandomState(3).rand(5)).requires_grad_(
        True)
    _check_layer(lambda x: conv(x, fill=fill), _x(2, 5, 16, 7),
                 [conv.weight, fill])
    conv2 = _conv(5, 5, 3, stride=2, padding=1, groups=5)
    _check_layer(lambda x: conv2(x, fill=fill), _x(2, 5, 16, 7),
                 [conv2.weight, fill])


@pytest.mark.parametrize("lower", [conv4x4s2_via_s2d, conv3x3s2_via_s2d])
def test_s2d_lowerings(lower):
    k = 4 if lower is conv4x4s2_via_s2d else 3
    conv = _conv(3, 4, k, stride=2, padding=1, s2d=True)
    _check_layer(conv, _x(2, 3, 16, 8), [conv.weight], spatial=4)


@pytest.mark.parametrize("s2d_convs", [0, 3])
def test_discriminator_stack(s2d_convs):
    d = FCDiscriminator(num_classes=19, ndf=8, dtype=F64, device="cpu",
                        s2d_convs=s2d_convs).double()
    x = torch.softmax(_x(2, 19, 64, 32), dim=1)
    _check_layer(d, x, list(d.parameters()))


@pytest.mark.parametrize("h,ratio", [(4, 4), (16, 4), (8, 2)])
def test_align_corners_resizes(h, ratio):
    """The decoder's (ASPP's output to the low-level size) and the logits'
    upsample (both x4), as bands; the output size is the band's, as the
    model gives it."""
    _check_layer(_resize_to(ratio, 24), _x(2, 3, h, 6))


def _resize_to(ratio, width):
    """x -> its align-corners resize to `ratio` times its rows and
    `width` columns; under row sharding the target level (ratio times
    x's) registered first, as the model's strided ops register theirs."""
    def fn(x):
        if halo.current() is not None:
            height, band = halo.level(x)
            halo.register(width, height * ratio, band * ratio)
        return resize_bilinear_align_corners(x, (x.shape[2] * ratio, width))
    return fn


def test_resize_four_bands():
    _check_layer(_resize_to(4, 12), _x(1, 2, 8, 3), spatial=4)


def test_resnet_max_pool():
    x = torch.relu(_x(2, 3, 16, 7))
    _check_layer(max_pool_3x3_s2, x, spatial=4)


@pytest.mark.parametrize("world,spatial", [(2, 2), (4, 2)])
@pytest.mark.parametrize("train", [False, True])
def test_aspp_pool_over_space(train, world, spatial):
    """ASPP at os 16 (dilations up to 18 past a band of 4 rows): in eval,
    and in train mode with BatchNorm synchronized over the world (the
    pooled branch's statistics over the 'data' group); at 2 x 2 the pool
    over the world, or the pooled branch's BatchNorm over it, would
    differ."""
    import copy

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
    rows = world // spatial
    x = _x(4, 6, 8, 5)
    u = torch.from_numpy(np.random.RandomState(9).randn(4, 256, 8, 5))
    copies = [copy.deepcopy(aspp) for _ in range(world)]

    def rank(layout, r):
        mod = copies[r]
        set_batchnorm_sync(mod, layout.world)
        d, s = layout.data.rank, layout.space.rank
        xb = _band(x[d::rows], s, spatial).clone().requires_grad_(True)
        with halo.row_shard(layout.space, x.shape[2], 1, layout.data):
            y = mod(xb)
        grads = torch.autograd.grad(
            (y * _band(u[d::rows], s, spatial)).sum(),
            [xb] + list(mod.parameters()))
        return y.detach(), grads, [b.clone() for b in mod.buffers()]

    out = _threads(world, spatial, rank)
    params = list(aspp.parameters())
    wy, wgx, wgp = _whole(aspp, x, params, u)
    y, gx = torch.empty_like(wy), torch.empty_like(wgx)
    hb = x.shape[2] // spatial
    for r, o in enumerate(out):
        d, s = divmod(r, spatial)
        y[d::rows, :, s * hb:(s + 1) * hb] = o[0]
        gx[d::rows, :, s * hb:(s + 1) * hb] = o[1][0]
    assert _rel(y, wy) <= 1e-12 and _rel(gx, wgx) <= 1e-12
    for i, want in enumerate(wgp):
        assert _rel(sum(o[1][i + 1] for o in out), want) <= 1e-12
    for got, want in zip(out[0][2], aspp.buffers()):  # running statistics
        assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("world,spatial", [(2, 2), (4, 2)])
def test_batchnorm_ring_count(world, spatial):
    """BatchNormTrain with a zero ring (zero_pad_width 2) on bands of the
    rows, synchronized over the world: y, the running statistics, dx and
    the summed dweight/dbias equal the whole batch's.  The count is the
    global image's ring; the parent's rule (the band's ring times the
    world) gives other statistics, which the last assert shows."""
    rs = np.random.RandomState(4)
    n, c, h, w, pad = 4, 3, 8, 5, 2
    x = torch.from_numpy(rs.randn(n, c, h, w) + 0.3)
    u = torch.from_numpy(rs.randn(n, c, h, w))
    ush = torch.from_numpy(rs.randn(c))
    weight = torch.from_numpy(rs.uniform(0.5, 1.5, c))
    bias = torch.from_numpy(rs.randn(c) * 0.1)
    rows = world // spatial

    def run(xx, wt, b, sync, rm, rv, uu, parts, count_rows):
        y, shift, _, _ = BN.BatchNormTrain.apply(
            xx, wt, b, 1e-5, pad, rm, rv, 0.1, sync, None, None, None,
            count_rows)
        return (y * uu).sum() + (shift * ush).sum() / parts

    rm, rv = torch.zeros(c, dtype=F64), torch.ones(c, dtype=F64)
    xw = x.clone().requires_grad_(True)
    wt, b = weight.clone().requires_grad_(True), bias.clone().requires_grad_(
        True)
    gx, gw, gb = torch.autograd.grad(run(xw, wt, b, None, rm, rv, u, 1, 1),
                                     [xw, wt, b])

    def rank(layout, r, count_rows):
        d, s = layout.data.rank, layout.space.rank
        xb = _band(x[d::rows], s, spatial).clone().requires_grad_(True)
        wr, br = weight.clone().requires_grad_(True), \
            bias.clone().requires_grad_(True)
        srm, srv = torch.zeros(c, dtype=F64), torch.ones(c, dtype=F64)
        g = torch.autograd.grad(
            run(xb, wr, br, layout.world, srm, srv,
                _band(u[d::rows], s, spatial), world, count_rows),
            [xb, wr, br])
        return g, srm, srv

    out = _threads(world, spatial, lambda lay, r: rank(lay, r, spatial))
    got = torch.empty_like(x)
    hb = h // spatial
    for r, o in enumerate(out):
        d, s = divmod(r, spatial)
        got[d::rows, :, s * hb:(s + 1) * hb] = o[0][0]
        assert torch.equal(o[1], out[0][1]) and torch.equal(o[2], out[0][2])
    assert _rel(got, gx) <= 1e-12
    assert _rel(sum(o[0][1] for o in out), gw) <= 1e-12
    assert _rel(sum(o[0][2] for o in out), gb) <= 1e-12
    assert _rel(out[0][1], rm) <= 1e-12 and _rel(out[0][2], rv) <= 1e-12
    # the parent's count: the band's ring on every band
    parent = _threads(world, spatial, lambda lay, r: rank(lay, r, 1))
    assert _rel(parent[0][2], rv) > 1e-3


def test_batch_softmax_over_the_data_group():
    """At 2 x 2, rank (d, s) holds samples d::2, rows band s: the
    batch-axis softmax over the 'data' group (the ranks with the same
    rows) equals the whole batch's; over the world it mixes pixels."""
    x = _x(4, 3, 8, 5)
    want = torch.softmax(x, dim=0)

    def run(layout, r):
        d, s = layout.data.rank, layout.space.rank
        xb = _band(x[d::2], s, 2)
        return (batch_softmax(xb, layout.data),
                batch_softmax(xb, layout.world))

    out = _threads(4, 2, run)
    for r, (good, bad) in enumerate(out):
        d, s = divmod(r, 2)
        band = _band(want[d::2], s, 2)
        assert _rel(good, band) <= 1e-12
        assert _rel(bad, band) > 1e-2


def test_mobilenet_eval_step_matches_jax():
    """The port's eval step row-sharded over 2 thread ranks on the JAX
    weights against the JAX package's unsharded eval step
    (tests/test_spatial_shard.py's bounds)."""
    from s2r_tpu.train.losses import build_seg_loss as jax_loss
    from s2r_tpu.train.steps import make_eval_step as jax_eval_step
    from s2r_tpu_torch.train.losses import build_seg_loss
    from s2r_tpu_torch.train.steps import make_eval_step

    hw, c = 64, 19
    model, params, stats = jax_deeplab(hw)
    rs = np.random.RandomState(1)
    image = rs.randn(1, hw, hw, 3).astype(np.float32)
    label = rs.randint(0, c, (1, hw, hw)).astype(np.int32)
    j_loss, j_cm, j_pred = jax.jit(jax_eval_step(model, jax_loss("ce"), c))(
        params, stats, jnp.asarray(image), jnp.asarray(label))
    port = [port_deeplab(params, stats) for _ in range(2)]

    def run(layout, r):
        step = make_eval_step(port[r], build_seg_loss("ce",
                                                      mesh=layout.world),
                              c, layout.world)
        band = slice(r * hw // 2, (r + 1) * hw // 2)
        return step(image[:, band], label[:, band], hw)

    out = _threads(2, 2, run)
    loss = sum(float(o[0]) for o in out)
    cm = sum(o[1] for o in out)
    pred = torch.cat([o[2] for o in out], dim=1)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(j_cm))
    agree = float((pred.numpy() == np.asarray(j_pred)).mean())
    assert agree > 0.999, agree


def _world_of(monkeypatch, world, rank=0):
    monkeypatch.setattr(M, "process_info", lambda: (rank, world))


def test_refusals(monkeypatch):
    """S not dividing the world; a world spanning nodes.  A batch not
    dividing the data rows takes fewer rows, as JAX does.  What they
    refused before runs now: a height not divisible by S times the
    path's stride (short bands), and batch
    padding under a spatial layout (a step builds)."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.train import losses as pl
    from s2r_tpu_torch.train import optim as po
    from s2r_tpu_torch.train.steps import make_output_adapt_step

    _world_of(monkeypatch, 3)
    with pytest.raises(ValueError, match=r"device count \(3\)"):
        M.pick_num_devices(6, None, 2)
    _world_of(monkeypatch, 4)
    # the batch does not divide the 2 data rows: JAX's one row x 2 bands,
    # the other two ranks idle (tests/test_torch_port_idle.py)
    assert M.pick_num_devices(3, None, 2) == 2
    assert M.pick_num_devices(2, None, 2) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="spans nodes"):
        M.pick_num_devices(4, None, 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with halo.row_shard(Mesh(2, 0), 513, 32) as rows:
        assert rows.size == 2
        assert halo.state().levels == {None: (513, 288)}
    # 48 rows over 2 at stride 32: bands of 32 and 16; 512 over 4: even
    assert M.band_rows(48, 2, 32) == 32
    assert M.band_bounds(48, 32, 1) == (32, 48)
    assert M.band_rows(512, 4, 32) == 128
    layout = M.make_layout(Mesh(2, 0), 2)
    assert layout.space.size == 2 and layout.data.size == 1
    model = DeepLab(device="cpu")
    d = FCDiscriminator(num_classes=19, device="cpu")
    assert callable(make_output_adapt_step(
        model, d, po.SGD(), po.Adam(), lambda s: 1e-3, pl.cross_entropy,
        pad_to=4, layout=layout))


@pytest.mark.parametrize("backbone", ["resnet50", "xception", "drn"])
def test_other_backbones_banded(backbone):
    """The other backbones through the same layers: DeepLab's train-mode
    forward and backward over 2 bands (BatchNorm synchronized over the
    bands, float64, at 64x64) equal the whole image's: logits, the
    input's gradient and every parameter's, within rel 1e-10 (the
    whole step's bound in tests/test_torch_port_distributed.py: float64
    rounding over ~100 layers reaches 1e-12)."""
    import copy

    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.models.layers import set_dropout

    model = DeepLab(backbone=backbone, dtype=F64, device="cpu",
                    generator=torch.Generator().manual_seed(1)).double()
    model.train()
    set_dropout(model, False)
    x = _x(1, 3, 64, 64, seed=3)
    copies = [copy.deepcopy(model) for _ in range(2)]
    with torch_threads():
        wy = model(x)[0]
    u = torch.from_numpy(np.random.RandomState(5).randn(*wy.shape))

    def rank(layout, r):
        mod = copies[r]
        set_batchnorm_sync(mod, layout.world)
        xb = _band(x, r, 2).clone().requires_grad_(True)
        with halo.row_shard(layout.space, 64, mod.row_stride, layout.data):
            y = mod(xb)[0]
        grads = torch.autograd.grad((y * _band(u, r, 2)).sum(),
                                    [xb] + list(mod.parameters()))
        return y.detach(), grads

    out = _threads(2, 2, rank)
    with torch_threads():
        _, wgx, wgp = _whole(lambda t: model(t)[0], x,
                             list(model.parameters()), u)
    assert _rel(torch.cat([o[0] for o in out], dim=2), wy.detach()) <= 1e-10
    assert _rel(torch.cat([o[1][0] for o in out], dim=2), wgx) <= 1e-10
    for i, want in enumerate(wgp):
        # the ranks' shares, summed; where they cancel (the pooled
        # branch's BatchNorm weight at one sample), relative to them
        parts = [o[1][i + 1] for o in out]
        scale = max(float(t.abs().max()) for t in parts + [want])
        assert float((sum(parts) - want).abs().max()) <= 1e-10 * scale, i
