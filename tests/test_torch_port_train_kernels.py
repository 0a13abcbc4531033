"""The port's training kernels against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
run only on the card, through chip_smoke.py).  The JAX side runs its Pallas
kernels in interpret mode at the shapes of its own tests
(tests/test_pallas_batchnorm.py, tests/test_pallas_disc.py,
tests/test_pallas_depthwise.py), and XLA's grouped conv where the Pallas
depthwise kernel is wrong (odd H at dilation 2, ROADMAP C).

Tolerances, all float32: sums and statistics rtol 1e-5 (one reduction in
another order); normalized outputs and gradients atol 1e-5 on values of
order 1-10 (the same formulas, rounded in another order); the train
BatchNorm module against JAX's XLA path rtol 1e-4 for its gradients (the
Pallas backward form against autodiff, as tests/test_pallas_batchnorm.py
holds them).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax

from s2r_tpu.models.layers import BatchNorm as JaxBatchNorm
from s2r_tpu.ops.pallas.batchnorm import batch_norm_train as jax_bn_train
from s2r_tpu.ops.pallas.batchnorm import pair_sums as jax_pair_sums
from s2r_tpu.ops.pallas.depthwise import depthwise_conv3x3 as jax_dw
from s2r_tpu.ops.pallas.disc_conv import disc_conv1 as jax_disc_conv1
from s2r_tpu_torch.io import convert
from s2r_tpu_torch.models.layers import BatchNorm
from s2r_tpu_torch.ops.kernels import build
from s2r_tpu_torch.ops.kernels import batchnorm as bnk
from s2r_tpu_torch.ops.kernels.batchnorm import BatchNormTrain
from s2r_tpu_torch.ops.kernels.depthwise import (DepthwiseConv3x3,
                                                 depthwise_dk)
from s2r_tpu_torch.ops.kernels.disc_conv import DiscConv1, disc_conv1


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_new_sources_are_registered_for_the_build():
    assert {"batchnorm", "disc_conv", "depthwise"} <= set(build.SOURCES)
    for name in build.SOURCES:
        assert (build.SRC_DIR / f"{name}.cu").is_file()


@pytest.mark.parametrize("same", [True, False])
def test_pair_sums_matches_pallas(same):
    """The per-channel pair sums the BatchNorm entries fold: (sum x, sum
    x^2) of batch_norm_stats when a is b, else (sum g, sum g*x) of
    batch_norm_grad_sums."""
    rng = np.random.RandomState(0)
    a = rng.randn(2, 8, 16, 32).astype(np.float32)
    b = a if same else rng.randn(2, 8, 16, 32).astype(np.float32)
    want = jax_pair_sums(jnp.asarray(a), jnp.asarray(b), interpret=True)
    at, bt = (torch.from_numpy(v).view(-1, 32) for v in (a, b))
    stats = bnk.batch_norm_stats(bt, torch.ones(32), torch.zeros(32),
                                 at.shape[0], 1e-5)
    if same:
        got = stats[bnk.SUM_X], stats[bnk.SUM_XX]
    else:
        grads = bnk.batch_norm_grad_sums(at, bt, stats, None, at.shape[0])
        got = grads[bnk.SUM_G], grads[bnk.SUM_GX]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (32,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_pair_sums_rejects_mismatched_shapes():
    stats = torch.zeros(bnk.STAT_ROWS, 5)
    with pytest.raises(ValueError):
        bnk.batch_norm_grad_sums(torch.zeros(4, 3), torch.zeros(4, 5), stats,
                                 None, 4)


def test_batch_norm_train_forward_and_vjp_match_pallas():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 8, 16).astype(np.float32) * 2 + 1
    scale = (rng.rand(16) + 0.5).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    g = rng.randn(2, 4, 8, 16).astype(np.float32)

    def loss(x, s, b):
        y, _, _ = jax_bn_train(x, s, b, 1e-5, True)
        return jnp.sum(y * g)

    y_j, mean_j, var_j = jax_bn_train(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), 1e-5, True)
    grads_j = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt = _nchw(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y, shift, mean, var = BatchNormTrain.apply(xt, st, bt, 1e-5, 0)
    (y * _nchw(g)).sum().backward()
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-5)
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(shift.detach().numpy(),
                               bias - mean.numpy() * scale
                               / np.sqrt(var.numpy() + 1e-5), atol=1e-5)
    for got, want in zip((_nhwc(xt.grad), st.grad.numpy(), bt.grad.numpy()),
                         grads_j):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("pad", [1, 2])
def test_train_batchnorm_ring_matches_jax_module(pad):
    """The train BatchNorm with zero_pad_width against JAX's XLA path:
    y, shift, the running statistics, and the gradients of x, scale and
    bias through y and through shift."""
    rng = np.random.RandomState(3 + pad)
    c = 12
    x = (rng.randn(2, 7, 9, c) * 1.5 + 0.3).astype(np.float32)
    p = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
         "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
         "var": (rng.rand(c) + 0.5).astype(np.float32)}
    gy = rng.randn(2, 7, 9, c).astype(np.float32)
    gs = rng.randn(c).astype(np.float32)
    mod = JaxBatchNorm()

    def run(params, x):
        (y, shift), upd = mod.apply({"params": params, "batch_stats": s}, x,
                                    False, zero_pad_width=pad,
                                    mutable=["batch_stats"])
        return y, shift, upd["batch_stats"]

    def loss(params, x):
        y, shift, _ = run(params, x)
        return jnp.sum(y * gy) + jnp.sum(shift * gs)

    y_j, shift_j, stats_j = run(p, jnp.asarray(x))
    gp_j, gx_j = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))

    bn = BatchNorm(c)
    state = {}
    convert._bn(state, "bn", p, s)
    bn.load_state_dict({k[3:]: v for k, v in state.items()})
    bn.train()
    xt = _nchw(x).requires_grad_()
    y, shift = bn(xt, ring=True, zero_pad_width=pad)
    ((y * _nchw(gy)).sum() + (shift * torch.from_numpy(gs)).sum()).backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(shift.detach().numpy(), np.asarray(shift_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats_j["mean"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats_j["var"]), rtol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(gp_j["scale"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp_j["bias"]),
                               rtol=1e-4, atol=1e-5)


def test_train_batchnorm_without_ring_matches_pallas_interpret():
    """The module's train path without the ring against JAX's module under
    set_bn_impl('pallas_interpret'), the JAX package's own kernel path."""
    from s2r_tpu.models import layers as L

    rng = np.random.RandomState(9)
    x = (rng.randn(2, 8, 8, 8) * 3).astype(np.float32)
    mod = JaxBatchNorm()
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    L.set_bn_impl("pallas_interpret")
    try:
        y_j, upd = mod.apply(variables, jnp.asarray(x), False,
                             mutable=["batch_stats"])
    finally:
        L.set_bn_impl("xla")
    bn = BatchNorm(8).train()
    y = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)


@pytest.mark.parametrize("shape,dilation", [
    ((2, 8, 16, 32), 1),    # tests/test_pallas_depthwise.py's shapes
    ((1, 12, 8, 24), 2),
    ((2, 7, 9, 5), 1),      # odd sizes, C far from 128
])
def test_depthwise_vjp_matches_pallas(shape, dilation):
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, shape[-1]) / 3).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)

    def loss(x, k):
        return jnp.sum(jax_dw(x, k, dilation, True) * g)

    gx_j, gk_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    (DepthwiseConv3x3.apply(xt, kt, dilation) * torch.from_numpy(g)).sum(
    ).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_j), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 13, 11, 24), (1, 33, 33, 96)])
def test_depthwise_vjp_odd_height_dilation2_matches_xla(shape):
    """Odd H at dilation 2, where the Pallas forward (and so its dx) is
    wrong: the reference is the VJP of XLA's grouped conv."""
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    k = rng.randn(3, 3, shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)

    def loss(x, k):
        y = lax.conv_general_dilated(
            x, k[:, :, None, :], (1, 1), ((2, 2), (2, 2)),
            rhs_dilation=(2, 2), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=shape[-1], precision="highest")
        return jnp.sum(y * g)

    gx_j, gk_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    (DepthwiseConv3x3.apply(xt, kt, 2) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_j), rtol=1e-5,
                               atol=1e-3)


def test_depthwise_dk_is_float32_of_bf16_inputs():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(1, 5, 6, 16).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 5, 6, 16).astype(np.float32))
    got = depthwise_dk(x.bfloat16(), g.bfloat16(), 1)
    want = depthwise_dk(x.bfloat16().float(), g.bfloat16().float(), 1)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


def _disc_inputs(n, h, c, w, ndf=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, c, w).astype(np.float32),
            (rng.randn(4, 4, c, ndf) * 0.1).astype(np.float32),
            (rng.randn(ndf) * 0.1).astype(np.float32))


@pytest.mark.parametrize("n,h,c,w", [(2, 16, 19, 32), (1, 48, 19, 32)])
def test_disc_conv1_matches_pallas(n, h, c, w):
    x, k, b = _disc_inputs(n, h, c, w)
    want = jax_disc_conv1(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                          True)
    got = disc_conv1(torch.from_numpy(x), torch.from_numpy(k),
                     torch.from_numpy(b))
    assert got.shape == (n, h // 2, w // 2, 64) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_disc_conv1_reads_the_nchw_map_through_strides():
    """The port hands the kernel a [N,H,C,W] view of an NCHW tensor."""
    x, k, b = _disc_inputs(2, 16, 19, 32, seed=1)
    nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
    view = nchw.permute(0, 2, 1, 3)
    assert not view.is_contiguous()
    got = disc_conv1(view, torch.from_numpy(k), torch.from_numpy(b))
    want = disc_conv1(torch.from_numpy(x), torch.from_numpy(k),
                      torch.from_numpy(b))
    assert torch.equal(got, want)


def test_disc_conv1_vjp_matches_pallas():
    x, k, b = _disc_inputs(2, 16, 19, 32, seed=2)

    def loss(x, k, b):
        return jnp.sum(jnp.tanh(jax_disc_conv1(x, k, b, True)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k),
                                             jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    torch.tanh(DiscConv1.apply(*ts)).sum().backward()
    for t, w, name in zip(ts, want, ("x", "kernel", "bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
