"""The port's layers (s2r_tpu_torch/models/layers.py, mobilenet.py,
ops/resize.py, ops/argmax.py) against the JAX package's, on the CPU in
float32 with the same numpy inputs.

Tolerance: atol 1e-5 (rtol 1e-5 for the block), float32 sums taken in
another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.models.layers import BatchNorm as JaxBatchNorm
from s2r_tpu.models.layers import Conv2d as JaxConv2d
from s2r_tpu.models.mobilenet import InvertedResidual as JaxBlock
from s2r_tpu.ops.resize import resize_bilinear_align_corners as jax_resize
from s2r_tpu_torch.io import convert
from s2r_tpu_torch.models.layers import BatchNorm, Conv2d
from s2r_tpu_torch.models.mobilenet import InvertedResidual
from s2r_tpu_torch.ops.argmax import argmax_first
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners

from _torch_port_common import perturb_stats


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("stride,dilation", [(1, 1), (1, 2), (2, 1)])
def test_conv_fill_identity_matches_jax(stride, dilation):
    """Depthwise conv with a `fill` ring: stride 1 runs the kernel module,
    stride 2 F.conv2d; both equal JAX's Conv2d(fill=...)."""
    rng = np.random.RandomState(0)
    c = 12
    x = rng.randn(2, 9, 11, c).astype(np.float32)
    kern = rng.randn(3, 3, 1, c).astype(np.float32)
    fill = rng.rand(c).astype(np.float32) * 3
    jconv = JaxConv2d(c, 3, stride=stride, padding=dilation,
                      dilation=dilation, groups=c)
    want = jconv.apply({"params": {"kernel": kern}}, jnp.asarray(x),
                       fill=jnp.asarray(fill))
    conv = Conv2d(c, c, 3, stride=stride, padding=dilation,
                  dilation=dilation, groups=c)
    assert conv.dw_stride1_3x3 == (stride == 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
        got = conv(_nchw(x), fill=torch.from_numpy(fill))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_conv_fill_equals_padding_with_the_value():
    """conv(pad_v(x)) == conv(pad_0(x - v)) + v * sum(k), checked against an
    explicitly padded tensor."""
    rng = np.random.RandomState(1)
    c, d = 6, 2
    x = torch.from_numpy(rng.randn(1, c, 7, 8).astype(np.float32))
    fill = torch.from_numpy(rng.rand(c).astype(np.float32))
    conv = Conv2d(c, c, 3, padding=d, dilation=d, groups=c)
    with torch.no_grad():
        got = conv(x, fill=fill)
        xp = fill.view(1, c, 1, 1).expand(1, c, 7 + 2 * d, 8 + 2 * d).clone()
        xp[:, :, d:-d, d:-d] = x
        want = torch.nn.functional.conv2d(xp, conv.weight, dilation=d,
                                          groups=c)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_eval_batchnorm_and_ring_match_jax():
    rng = np.random.RandomState(2)
    c = 10
    x = rng.randn(2, 5, 6, c).astype(np.float32)
    p = {"scale": rng.rand(c).astype(np.float32) + 0.5,
         "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": rng.randn(c).astype(np.float32),
         "var": rng.rand(c).astype(np.float32) + 0.5}
    want_y, want_ring = JaxBatchNorm().apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x), True,
        zero_pad_width=2)
    bn = BatchNorm(c).eval()  # a new torch module starts in train mode
    state = {}
    convert._bn(state, "bn", p, s)
    bn.load_state_dict({k[3:]: v for k, v in state.items()})
    with torch.no_grad():
        y, ring = bn(_nchw(x), ring=True)
        y_only = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ring.numpy(), np.asarray(want_ring), rtol=0,
                               atol=1e-6)
    assert torch.equal(y, y_only)


@pytest.mark.parametrize("in_ch,out_ch,stride,dilation,t", [
    (16, 24, 2, 1, 6),   # stride-2 depthwise with the ring (F.conv2d)
    (24, 24, 1, 2, 6),   # stride-1 dilated depthwise with the ring, residual
    (32, 16, 1, 1, 1),   # no expand conv: plain zero padding
])
def test_inverted_residual_matches_jax(in_ch, out_ch, stride, dilation, t):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, in_ch).astype(np.float32)
    jblock = JaxBlock(out_ch=out_ch, stride=stride, dilation=dilation,
                      expand_ratio=t)
    v = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x), False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = perturb_stats(jax.tree_util.tree_map(np.asarray,
                                                 v["batch_stats"]), seed=4)
    want = jblock.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), False)
    subs = ("dw_conv", "dw_bn", None, "project_conv", "project_bn")
    if t != 1:
        subs = ("expand_conv", "expand_bn", None) + subs
    state = {}
    for j, sub in enumerate(subs):
        if sub is None:
            continue
        if sub.endswith("_bn"):
            convert._bn(state, f"conv.{j}", params[sub], stats[sub])
        else:
            convert._conv(state, f"conv.{j}", params[sub])
    block = InvertedResidual(in_ch, out_ch, stride, dilation, t).eval()
    block.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = block(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((5, 9), (17, 33)), ((1, 4), (3, 4)),
                                          ((17, 17), (65, 65))])
def test_resize_matches_jax(in_hw, out_hw):
    rng = np.random.RandomState(5)
    x = rng.randn(2, *in_hw, 3).astype(np.float32)
    want = jax_resize(jnp.asarray(x), out_hw)
    got = resize_bilinear_align_corners(_nchw(x), out_hw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert resize_bilinear_align_corners(_nchw(x), out_hw,
                                         dtype=torch.bfloat16).dtype \
        == torch.bfloat16


def test_resize_matches_torch_interpolate():
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 4, 7, 10)
                         .astype(np.float32))
    want = torch.nn.functional.interpolate(x, size=(13, 29), mode="bilinear",
                                           align_corners=True)
    torch.testing.assert_close(resize_bilinear_align_corners(x, (13, 29)),
                               want, rtol=0, atol=1e-5)


def test_argmax_first_index_ties():
    """Exact ties go to the first index, as jnp.argmax and np.argmax."""
    x = np.zeros((2, 19, 3, 4), np.float32)
    x[0, 5], x[0, 2] = 1.0, 1.0          # tie between channels 2 and 5
    x[1, 18], x[1, 7], x[1, 9] = 2.0, 2.0, 2.0
    x[1, :, 0, 0] = 0.0                   # all-equal column -> 0
    got = argmax_first(torch.from_numpy(x), dim=1).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == 2 and got[1, 1, 1] == 7 and got[1, 0, 0] == 0
