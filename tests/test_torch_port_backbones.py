"""The port's other backbones (ResNet-101/50, Aligned Xception-65, DRN-D-54)
and MobileNetV2 at output stride 8, against the JAX package, on the CPU.

Set-up, per backbone: the JAX package's output_adapt method at its init
(PRNGKey(5)); G's BatchNorm running statistics are then set to the batch
statistics of a seeded 65x65 batch-2 image (a train-mode forward of the
port with momentum 1), so that the eval forward stays near unit scale
through every layer instead of growing by orders of magnitude over the
residual stages, as random statistics make it.

- The eval forward at 65x65 batch 2 (ResNet-101 at 33x33), float32:
  logits and the ASPP feature within 1e-4 * max(1, max|logit|) of JAX's
  (the tolerance of tests/test_torch_port_model.py).
- The weights: from_jax_variables gives s2r_tpu/io/torch_export.py
  ``export_deeplab(..., backbone=)``'s keys and values exactly, the port's
  state_dict has those keys and loads them with strict=True, and
  to_jax_variables inverts it bit for bit.
- The parameter orders: deeplab_param_order is the order
  jax.tree_util flattens JAX's params in (``block10`` before ``block2``),
  and reference_param_order the order the JAX package's torch importers
  record (``order_sink``).
- The checkpoints of each backbone: tests/test_torch_port_backbone_io.py.
- decoder-int8 at the low-level widths 128 (Xception) and 256 (ResNet-50,
  DRN): the port's int8 tail on JAX's taps within 1e-4 * max|logit| of the
  JAX tail with its Pallas requant in interpret mode, labels equal.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s2r_tpu.ops.pallas.requant as jax_rq
from s2r_tpu.io.quant import backbone_taps, calibrate_decoder_int8
from s2r_tpu.io.quant import make_decoder_tail as jax_tail
from s2r_tpu.io.torch_export import export_deeplab
from s2r_tpu.io.torch_import import _backbone_importer
from s2r_tpu.models import DeepLab as JaxDeepLab
from s2r_tpu_torch.io.convert import (_layout, deeplab_param_order,
                                      from_jax_variables,
                                      reference_param_order,
                                      to_jax_variables)
from s2r_tpu_torch.io.quant import make_decoder_tail as port_tail
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.tools.step_conditioning import warm_batchnorm

from _torch_port_common import images, jax_output_adapt, torch_threads

HW = 65
# (backbone, output stride, forward size)
FORWARDS = [("resnet50", 16, HW), ("resnet101", 16, 33), ("xception", 16, HW),
            ("xception", 8, HW), ("drn", 16, HW), ("mobilenet", 8, HW)]
BACKBONES = ("resnet50", "resnet101", "xception", "drn")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _variables(backbone, os_=16, hw=HW):
    """G's (params, batch_stats warmed on a seeded hw x hw batch) as numpy
    trees."""
    _, js = jax_output_adapt(backbone)
    params, stats = _np(js.params["G"]), _np(js.batch_stats)
    model = DeepLab(output_stride=os_, device="cpu", backbone=backbone)
    model.load_state_dict(from_jax_variables(params, stats, backbone))
    with torch_threads():
        warm_batchnorm(model, torch.from_numpy(images(hw=hw, seed=9)).permute(
            0, 3, 1, 2))
    return params, to_jax_variables(model.state_dict(), backbone)[1]


def _port(backbone, os_=16, hw=HW):
    params, stats = _variables(backbone, os_, hw)
    model = DeepLab(output_stride=os_, device="cpu", backbone=backbone)
    model.load_state_dict(from_jax_variables(params, stats, backbone),
                          strict=True)
    return model


@pytest.mark.parametrize("backbone,os_,hw", FORWARDS,
                         ids=[f"{b}-os{o}" for b, o, _ in FORWARDS])
def test_logits_match_jax(backbone, os_, hw):
    params, stats = _variables(backbone, os_, hw)
    model = _port(backbone, os_, hw)
    x = images(hw=hw, seed=3)
    jmodel = JaxDeepLab(backbone=backbone, output_stride=os_, num_classes=19)
    want, want_feat = jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), False)
    want, want_feat = np.asarray(want), np.asarray(want_feat)
    with torch.inference_mode(), torch_threads():
        got, feat = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, hw, hw, 19)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(), want_feat,
                               rtol=0, atol=tol)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_weights_are_export_deeplab_key_for_key(backbone):
    params, stats = _variables(backbone)
    got = from_jax_variables(params, stats, backbone)
    want = export_deeplab(params, stats, 16, backbone=backbone)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    model = DeepLab(device="cpu", backbone=backbone)
    assert sorted(model.state_dict()) == sorted(want)
    model.load_state_dict(got, strict=True)
    p2, s2 = to_jax_variables(model.state_dict(), backbone)
    for a, b in ((params, p2), (stats, s2)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        assert all(x.dtype == y.dtype and np.array_equal(x, y)
                   for x, y in zip(la, lb))


def _key_of(backbone):
    """JAX param path -> the port's parameter name."""
    names = {"conv": (("kernel", "weight"),),
             "conv_bias": (("kernel", "weight"), ("bias", "bias")),
             "bn": (("scale", "weight"), ("bias", "bias"))}
    return {path + (j,): f"{key}.{t}" for path, key, kind in _layout(backbone)
            for j, t in names[kind]}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_param_orders_are_jax_orders(backbone):
    params, _ = _variables(backbone)
    key_of = _key_of(backbone)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    jax_order = [key_of[tuple(k.key for k in path)] for path, _ in flat]
    assert deeplab_param_order(backbone) == jax_order
    first = {"resnet101": ("layer3.10.", "layer3.2."),
             "xception": ("block10.", "block2.")}.get(backbone)
    if first:  # keys sorted as strings, not in module order
        at = [next(i for i, k in enumerate(jax_order)
                   if k.startswith("backbone." + f)) for f in first]
        assert at[0] < at[1]
    sd = export_deeplab(params, _variables(backbone)[1], 16,
                        backbone=backbone)
    sink = []
    _backbone_importer(backbone)(sd, 16, prefix="backbone.",
                                 order_sink=sink, path_prefix=("backbone",))
    want = [key_of[path] for path, _ in sink]
    assert reference_param_order(backbone, ("backbone",)) == want


def _pallas_interpret():
    orig = jax_rq.requant_s32_to_s8
    return mock.patch.object(
        jax_rq, "requant_s32_to_s8",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("backbone,width", [("xception", 128),
                                            ("resnet50", 256),
                                            ("drn", 256)])
def test_int8_tail_at_low_level_width(backbone, width):
    params, stats = _variables(backbone)
    model = _port(backbone)
    assert model.decoder.conv1.in_channels == width
    jmodel = JaxDeepLab(backbone=backbone, num_classes=19)
    variables = {"params": params, "batch_stats": stats}
    scales = calibrate_decoder_int8(jmodel, params, stats,
                                    [images(seed=7), images(seed=8)])
    feat, low = backbone_taps(jmodel.clone(upsample_logits=False), variables,
                              jnp.asarray(images(seed=11)))
    feat, low = np.array(feat), np.array(low)
    assert low.shape == (2, 17, 17, width)
    with _pallas_interpret():
        want = np.asarray(jax_tail(params["decoder"], stats["decoder"],
                                   scales=scales, requant="pallas")(
            jnp.asarray(feat), jnp.asarray(low)))
    with torch.inference_mode():
        got = port_tail(model.decoder, scales=scales)(
            torch.from_numpy(feat).permute(0, 3, 1, 2),
            torch.from_numpy(low).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 17, 17, 19)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
