"""The port's space-to-depth convolutions (s2r_tpu_torch/ops/s2d.py) and the
options built on them (Conv2d ``s2d``, MobileNetV2 / DeepLab ``stem_s2d``,
FCDiscriminator ``s2d_convs``) against the JAX package's s2r_tpu/ops/s2d.py
and models, on the CPU in float32.

- space_to_depth and the two kernel scatters equal JAX's exactly (NCHW /
  OIHW against NHWC / HWIO);
- conv4x4s2_via_s2d and conv3x3s2_via_s2d at tests/test_ops.py's shapes:
  forward within 1e-4 of JAX's and of the direct F.conv2d, the gradients
  to x and to the kernel within JAX's own bounds there (rtol 1e-3, atol
  1e-2 on gradients of O(100));
- DeepLab(stem_s2d=True) in eval against JAX's on the same weights (rtol
  and atol 2e-4, test_ops.py:123-143); at 65x97 the stem falls back to the
  direct conv and the logits equal the default model's exactly;
  stem_s2d on another backbone raises a ValueError (the JAX package
  ignores it, ROADMAP C.7);
- FCDiscriminator(s2d_convs=2) against JAX's, forward and the gradient to
  its input; s2d_convs=1 is the default model exactly (conv1 stays on
  the hand-written kernel).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from s2r_tpu.models import DeepLab as JaxDeepLab
from s2r_tpu.models import FCDiscriminator as JaxFCDiscriminator
from s2r_tpu.ops import s2d as js2d
from s2r_tpu_torch.io.convert import from_jax_discriminator
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.models.discriminator import FCDiscriminator
from s2r_tpu_torch.models.layers import Conv2d
from s2r_tpu_torch.ops import s2d

from _torch_port_common import jax_deeplab, port_deeplab, torch_threads


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _hwio(t):
    return t.detach().permute(2, 3, 1, 0).numpy()


def test_space_to_depth_and_kernels_equal_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(s2d.space_to_depth(_nchw(x))),
        np.asarray(js2d.space_to_depth(jnp.asarray(x))))
    for taps, jfn, pfn in ((4, js2d.s2d_kernel_4x4s2, s2d.s2d_kernel_4x4s2),
                           (3, js2d.s2d_kernel_3x3s2, s2d.s2d_kernel_3x3s2)):
        k = rng.randn(taps, taps, 5, 7).astype(np.float32)
        np.testing.assert_array_equal(_hwio(pfn(_oihw(k))),
                                      np.asarray(jfn(jnp.asarray(k))))
    with pytest.raises(ValueError):
        s2d.space_to_depth(torch.zeros(1, 3, 5, 4))


CASES = [("4x4", (16, 24), 19, 64), ("4x4", (8, 8), 64, 128),
         ("4x4", (12, 20), 3, 5), ("3x3", (16, 24), 3, 32),
         ("3x3", (12, 20), 5, 7)]


@pytest.mark.parametrize("form,hw,cin,cout", CASES)
def test_s2d_conv_matches_jax_and_direct(form, hw, cin, cout):
    taps = 4 if form == "4x4" else 3
    jfn = js2d.conv4x4s2_via_s2d if taps == 4 else js2d.conv3x3s2_via_s2d
    pfn = s2d.conv4x4s2_via_s2d if taps == 4 else s2d.conv3x3s2_via_s2d
    rng = np.random.RandomState(0)
    x = rng.randn(2, *hw, cin).astype(np.float32)
    k = rng.randn(taps, taps, cin, cout).astype(np.float32)

    def jloss(x, k):
        return jnp.sum(jfn(x, k) ** 2)

    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k)))
    jgx, jgk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = _nchw(x).requires_grad_(True)
    kt = _oihw(k).requires_grad_(True)
    got = pfn(xt, kt)
    gx, gk = torch.autograd.grad((got ** 2).sum(), (xt, kt))
    direct = F.conv2d(xt, kt, stride=2, padding=1)
    dgx, dgk = torch.autograd.grad((direct ** 2).sum(), (xt, kt))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_nhwc(got), _nhwc(direct), rtol=1e-4,
                               atol=1e-4)
    for g, jg, dg, to in ((gx, jgx, dgx, _nhwc), (gk, jgk, dgk, _hwio)):
        np.testing.assert_allclose(to(g), np.asarray(jg), rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(to(g), to(dg), rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("taps,hw", [(4, (16, 24)), (3, (12, 20)),
                                     (4, (15, 24)), (3, (13, 13))])
def test_conv2d_s2d_option(taps, hw):
    """Conv2d(s2d=True) equals the plain conv on the same parameters, and
    is the direct conv, bit for bit, on an odd size."""
    torch.manual_seed(0)
    plain = Conv2d(6, 8, taps, stride=2, padding=1, bias=True)
    fast = Conv2d(6, 8, taps, stride=2, padding=1, bias=True, s2d=True)
    fast.load_state_dict(plain.state_dict())
    x = torch.randn(2, 6, *hw)
    with torch.no_grad():
        got, want = fast(x), plain(x)
    if hw[0] % 2 or hw[1] % 2:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_stem_s2d_deeplab_matches_jax():
    _, params, stats = jax_deeplab(64)
    jfast = JaxDeepLab(output_stride=16, num_classes=19, stem_s2d=True)
    base = port_deeplab(params, stats)
    fast = DeepLab(num_classes=19, output_stride=16, device="cpu",
                   stem_s2d=True)
    fast.load_state_dict(base.state_dict(), strict=True)
    assert fast.stem_s2d and fast.backbone.features[0][0].s2d
    rng = np.random.RandomState(2)
    v = {"params": params, "batch_stats": stats}
    apply = jax.jit(lambda v, x: jfast.apply(v, x, False)[0])
    for hw in ((64, 96), (65, 97)):
        x = rng.randn(1, *hw, 3).astype(np.float32)
        want = np.asarray(apply(v, jnp.asarray(x)))
        with torch_threads(), torch.no_grad():
            got = fast(_nchw(x))[0]
            plain = base(_nchw(x))[0]
        np.testing.assert_allclose(_nhwc(got), want, rtol=2e-4, atol=2e-4)
        if hw[0] % 2:
            assert torch.equal(got, plain)  # the direct stem


@pytest.mark.parametrize("backbone", ["resnet", "xception", "drn"])
def test_stem_s2d_on_another_backbone_raises(backbone):
    with pytest.raises(ValueError, match="stem_s2d"):
        DeepLab(backbone=backbone, device="cpu", stem_s2d=True)


def test_discriminator_s2d_convs_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 96, 19).astype(np.float32)
    jd = JaxFCDiscriminator(s2d_convs=2)
    params = jd.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params["params"])

    def jloss(x):
        return jnp.sum(jd.apply({"params": params}, x) ** 2)

    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    jgx = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    outs = {}
    for n in (0, 1, 2):
        d = FCDiscriminator(device="cpu", s2d_convs=n)
        d.load_state_dict(from_jax_discriminator(params), strict=True)
        xt = _nchw(x).requires_grad_(True)
        y = d(xt)
        (gx,) = torch.autograd.grad((y ** 2).sum(), xt)
        outs[n] = (y.detach(), gx)
    np.testing.assert_allclose(_nhwc(outs[2][0]), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_nhwc(outs[2][1]), jgx, rtol=1e-3, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(outs[1], outs[0]))
    assert not torch.equal(outs[2][0], outs[0][0])  # conv2 took the s2d form
