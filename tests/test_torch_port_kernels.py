"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
run only on the card, through chip_smoke.py).  The JAX side runs the Pallas
kernels in interpret mode, as tests/test_pallas_depthwise.py and
tests/test_quant.py do.

Tolerances: depthwise float32 atol 1e-5 (the same nine products summed in
another order); bfloat16 one bf16 rounding step (rtol 2**-7); requant bit
for bit (the same rounded float32 operations).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax import lax

from s2r_tpu.ops.pallas.depthwise import depthwise_conv3x3 as jax_dw
from s2r_tpu.ops.pallas.requant import requant_s32_to_s8 as jax_requant
from s2r_tpu.ops.pallas.requant import requant_xla
from s2r_tpu_torch.ops.kernels import build
from s2r_tpu_torch.ops.kernels.depthwise import (depthwise_conv3x3,
                                                 depthwise_conv3x3_plain)
from s2r_tpu_torch.ops.kernels.requant import (requant_plain,
                                               requant_s32_to_s8)


@pytest.mark.parametrize("shape,dilation", [
    ((2, 7, 9, 5), 1),      # C far from 128, odd H and W
    ((1, 14, 11, 24), 2),   # atrous, odd W
    ((2, 9, 8, 144), 1),    # a MobileNetV2 hidden width
    ((1, 4, 5, 3), 2),      # image smaller than the dilated window
])
def test_depthwise_matches_pallas_f32(shape, dilation):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    k = rng.randn(3, 3, shape[-1]).astype(np.float32)
    want = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(k), dilation, True))
    got = depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(k), dilation)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 13, 11, 24), (1, 5, 5, 3),
                                   (1, 33, 33, 960)])
def test_depthwise_odd_height_dilation2_matches_xla_conv(shape):
    """Odd H at dilation 2 (MobileNetV2's last block at 513x513 runs at
    33x33, C=960): the Pallas kernel picks a one-row tile there, shorter
    than the dilation, and its halo copy reads the wrong rows (off by up to
    24 on these inputs), so the reference is the XLA grouped conv that the
    JAX model runs (s2r_tpu/models/layers.py:187)."""
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    k = rng.randn(3, 3, shape[-1]).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k)[:, :, None, :], (1, 1),
        ((2, 2), (2, 2)), rhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=shape[-1], precision="highest")
    got = depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(k), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_depthwise_matches_pallas_bf16():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 7, 40).astype(np.float32)
    k = rng.randn(3, 3, 40).astype(np.float32)
    want = np.asarray(jax_dw(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(k, jnp.bfloat16), 1, True)
                      ).astype(np.float32)
    got = depthwise_conv3x3(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(k).bfloat16(), 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_depthwise_cpu_wrapper_is_plain_and_launches_nothing():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 6, 5, 7).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 3, 7).astype(np.float32))
    before = depthwise_conv3x3.launches
    assert torch.equal(depthwise_conv3x3(x, k, 2),
                       depthwise_conv3x3_plain(x, k, 2))
    assert depthwise_conv3x3.launches == before


@pytest.mark.parametrize("bad", ["k_shape", "dilation", "rank", "device"])
def test_depthwise_rejects(bad):
    x = torch.zeros(1, 4, 4, 8)
    k = torch.zeros(3, 3, 8)
    if bad == "k_shape":
        k = torch.zeros(3, 3, 7)
    elif bad == "dilation":
        with pytest.raises(ValueError):
            depthwise_conv3x3(x, k, 0)
        return
    elif bad == "rank":
        x = torch.zeros(4, 4, 8)
    else:  # a device with no kernel and no plain path: raise, never fall back
        x, k = x.to("meta"), k.to("meta")
    with pytest.raises(ValueError):
        depthwise_conv3x3(x, k, 1)


def _requant_inputs(shape, seed):
    """Random accumulators, plus channels whose x*m*2 + b*2 lands on exact
    .5 ties (m = 0.25 with odd x; m = 0.5, b = 0.25) and past both clamp
    ends."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randint(-2 ** 20, 2 ** 20, shape).astype(np.int32)
    m = (rng.rand(c) * 1e-4).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    q = c // 4
    x[..., :q] = rng.randint(-41, 300, shape[:-1] + (q,))
    m[:q], b[:q] = 0.25, 0.0
    x[..., q:2 * q] = rng.randint(-20, 150, shape[:-1] + (q,))
    m[q:2 * q], b[q:2 * q] = 0.5, 0.25
    return x, m, b


@pytest.mark.parametrize("inv", [2.0, 1.0 / 0.75])  # 2.0 keeps the ties
@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (1, 5, 7, 24)])
def test_requant_matches_pallas_and_xla_bit_exact(shape, inv):
    x, m, b = _requant_inputs(shape, seed=3)
    inv = np.float32(inv)
    got = requant_s32_to_s8(torch.from_numpy(x), torch.from_numpy(m),
                            torch.from_numpy(b), inv).numpy()
    pallas = np.asarray(jax_requant(jnp.asarray(x), jnp.asarray(m),
                                    jnp.asarray(b), jnp.float32(inv),
                                    interpret=True))
    xla = np.asarray(requant_xla(jnp.asarray(x), m * inv, b * inv))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    assert got.min() == 0 and got.max() == 127


def test_requant_half_to_even_ties():
    """Exact .5 ties round to even, as jnp.round and rintf do."""
    x = torch.tensor([[1, 3, 5, 7, 9, 253]], dtype=torch.int32)
    m = torch.full((6,), 0.5)
    got = requant_s32_to_s8(x, m, torch.zeros(6))
    assert got.tolist() == [[0, 2, 2, 4, 4, 126]]


def test_requant_cpu_wrapper_is_plain_and_launches_nothing():
    x, m, b = _requant_inputs((3, 4, 32), seed=4)
    xt, mt, bt = torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(b)
    before = requant_s32_to_s8.launches
    assert torch.equal(requant_s32_to_s8(xt, mt, bt), requant_plain(xt, mt, bt))
    assert requant_s32_to_s8.launches == before


@pytest.mark.parametrize("bad", ["dtype", "channels", "device"])
def test_requant_rejects(bad):
    x = torch.zeros(2, 8, dtype=torch.int32)
    m, b = torch.ones(8), torch.zeros(8)
    if bad == "dtype":
        with pytest.raises(TypeError):
            requant_s32_to_s8(x.float(), m, b)
        return
    if bad == "channels":
        m = torch.ones(7)
    else:
        x, m, b = x.to("meta"), m.to("meta"), b.to("meta")
    with pytest.raises(ValueError):
        requant_s32_to_s8(x, m, b)


def test_launch_error_raises():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        build.check(9, "kernel")


def test_build_target_is_keyed_by_source_and_flags():
    so = build._target("depthwise")
    assert so.parent == build.BUILD_DIR and so.suffix == ".so"
    assert so.name.startswith("depthwise-")
    assert build._target("requant") != so
