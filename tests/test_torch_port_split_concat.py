"""The model's ``split_concat`` and ``logits_dtype`` (``--split-concat``,
``--logits-dtype``) against the JAX package, on the CPU.

- ``Conv2d`` with a tuple input equals the conv of the concat of its parts
  (float32 within 1e-5 of the output's scale, float64 within 1e-12),
  a [1, 1] part broadcast under a 1x1 kernel included; a [1, 1] part under
  padding raises (the JAX package lets it through: ADVICE.md, ROADMAP
  C.7), and so does a [1, 1] part under a 3x3 kernel, as in JAX.
- ASPP (the ASPP feature), the decoder (decoder-resolution logits) and
  DeepLab (full-resolution logits) with split_concat against JAX's
  ``DeepLab(split_concat=True)`` at 65x65 batch 2 float32 in eval, on
  MobileNetV2 (perturbed statistics) and ResNet-50 (statistics warmed on a
  seeded batch, as tests/test_torch_port_backbones.py does):
  max|diff| <= 1e-4 * max(1, max|logit|), the tolerance of
  tests/test_torch_port_model.py.  The state_dict is the same with the
  flag on and off.
- ``logits_dtype='bf16'``: bfloat16 logits from a train-mode forward,
  float32 from an eval one.  The output step with ``--logits-dtype bf16``
  (64x64 batch 2, float32 compute, dropout off) from JAX's state against
  JAX's step with ``logits_dtype='bf16'``: losses within rtol 1e-4.  The
  spread that sets it, measured on this step: the port against JAX
  <= 7.5e-6 relative, the port's bfloat16 logits against its float32
  ones <= 8.0e-6 (the losses are means over 8192 pixels, where the
  logits' rounding mostly averages out; the bf16 losses differ from the
  float32 ones, which the test asserts too).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.models import DeepLab as JaxDeepLab
from s2r_tpu.models import layers as JL
from s2r_tpu.models.layers import Conv2d as JaxConv2d
from s2r_tpu.train.setup import build_method as jax_build_method
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.io.convert import (from_jax_variables, to_jax_variables,
                                      train_state_from_jax)
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.models.layers import Conv2d, set_dropout
from s2r_tpu_torch.tools.step_conditioning import warm_batchnorm
from s2r_tpu_torch.train.setup import build_method

from _torch_port_common import (images, jax_deeplab, jax_output_adapt,
                                perturb_affine, step_batches, torch_threads)

HW = 65


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("kernel,pad,bias", [(3, 1, True), (1, 0, False),
                                             (3, 2, False)])
def test_conv_tuple_input_equals_concat(dtype, tol, kernel, pad, bias):
    rs = np.random.RandomState(kernel + pad)
    parts = [rs.randn(2, c, 9, 11) for c in (5, 3, 4)]
    conv = Conv2d(12, 7, kernel, padding=pad, dilation=max(pad, 1),
                  bias=bias).to(dtype)
    xs = [_t(p, dtype) for p in parts]
    with torch.no_grad():
        want = conv(torch.cat(xs, dim=1))
        got = conv(tuple(xs))
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_conv_tuple_broadcast_part(dtype, tol):
    """A [N,C,1,1] part under a 1x1 kernel broadcasts into the sum (ASPP's
    pool branch), first or last among the parts; the JAX package's split
    conv on the same weights agrees."""
    rs = np.random.RandomState(3)
    a = rs.randn(2, 4, 6, 7)
    g = rs.randn(2, 3, 1, 1)
    conv = Conv2d(7, 5, 1, bias=True).to(dtype)
    full = torch.cat([_t(a, dtype), _t(g, dtype).expand(-1, -1, 6, 7)], 1)
    with torch.no_grad():
        want = conv(full)
        got = conv((_t(a, dtype), _t(g, dtype)))
        assert got.shape == want.shape
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), err
        conv_rev = Conv2d(7, 5, 1).to(dtype)
        conv_rev.weight.copy_(torch.cat([conv.weight[:, 4:],
                                         conv.weight[:, :4]], 1))
        got = conv_rev((_t(g, dtype), _t(a, dtype)))
        err = float((got - (want - conv.bias.view(1, -1, 1, 1))).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), err
    if dtype == torch.float32:
        jconv = JaxConv2d(5, 1, use_bias=True)
        kern = conv.weight.detach().numpy().transpose(2, 3, 1, 0)
        v = {"params": {"kernel": jnp.asarray(kern),
                        "bias": jnp.asarray(conv.bias.detach().numpy())}}
        jy = jconv.apply(v, (jnp.asarray(a.transpose(0, 2, 3, 1), jnp.float32),
                             jnp.asarray(g.transpose(0, 2, 3, 1), jnp.float32)))
        np.testing.assert_allclose(np.asarray(jy).transpose(0, 3, 1, 2),
                                   want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_conv_tuple_padded_broadcast_part_raises():
    """A [1,1] part under padding would put its value in the padded ring,
    where the concat holds zeros: it raises (the JAX package lets it
    through, s2r_tpu/models/layers.py:125).  Under a 3x3 kernel it raises
    as it does in JAX; parts of two spatial sizes, or of more channels
    than the conv takes, raise too."""
    a, g = torch.randn(2, 4, 6, 6), torch.randn(2, 3, 1, 1)
    with pytest.raises(ValueError, match="without padding"):
        Conv2d(7, 5, 1, padding=1)((a, g))
    with pytest.raises(ValueError, match="1x1 kernel"):
        Conv2d(7, 5, 3, padding=1)((a, g))
    with pytest.raises(ValueError, match="spatial size"):
        Conv2d(7, 5, 1)((a, torch.randn(2, 3, 3, 3)))
    with pytest.raises(ValueError, match="channels"):
        Conv2d(6, 5, 1)((a, g))


@functools.lru_cache(maxsize=None)
def _resnet_variables():
    """ResNet-50's G (params, statistics warmed on a seeded 65x65 batch)."""
    _, js = jax_output_adapt("resnet50")
    params, stats = _np(js.params["G"]), _np(js.batch_stats)
    model = DeepLab(device="cpu", backbone="resnet50")
    model.load_state_dict(from_jax_variables(params, stats, "resnet50"))
    with torch_threads():
        warm_batchnorm(model, torch.from_numpy(images(hw=HW, seed=9)).permute(
            0, 3, 1, 2))
    return params, to_jax_variables(model.state_dict(), "resnet50")[1]


def _variables(backbone):
    if backbone == "mobilenet":
        _, params, stats = jax_deeplab(HW)
        return params, stats
    return _resnet_variables()


@pytest.mark.parametrize("backbone", ["mobilenet", "resnet50"])
def test_split_concat_model_matches_jax(backbone):
    params, stats = _variables(backbone)
    x = images(seed=5)
    sd = from_jax_variables(params, stats, backbone)
    port = DeepLab(device="cpu", backbone=backbone, split_concat=True)
    plain = DeepLab(device="cpu", backbone=backbone)
    assert list(port.state_dict()) == list(plain.state_dict())
    assert all(v.shape == plain.state_dict()[k].shape
               for k, v in port.state_dict().items())
    port.load_state_dict(sd, strict=True)
    jmodel = JaxDeepLab(backbone=backbone, output_stride=16, num_classes=19,
                        split_concat=True)
    v = {"params": params, "batch_stats": stats}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for upsample in (False, True):
        want, want_feat = jmodel.clone(upsample_logits=upsample).apply(
            v, jnp.asarray(x), False)
        want = np.asarray(want)
        with torch_threads(), torch.inference_mode():
            got, feat = port(xt, upsample_logits=upsample)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"upsample {upsample}")
        np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want_feat), rtol=0, atol=tol,
                                   err_msg="ASPP feature")


def test_logits_dtype_bf16_train_only():
    model = DeepLab(device="cpu", logits_dtype="bf16")
    x = torch.from_numpy(images(hw=33, seed=1)).permute(0, 3, 1, 2)
    set_dropout(model, False)
    with torch_threads():
        model.train()
        train_logits, _ = model(x)
        model.eval()
        with torch.inference_mode():
            eval_logits, _ = model(x)
            low, _ = model(x, upsample_logits=False)
    assert train_logits.dtype == torch.bfloat16
    assert eval_logits.dtype == torch.float32
    assert low.dtype == torch.float32 and low.shape[-1] == 9
    assert DeepLab(device="cpu", logits_dtype="f32").logits_dtype is None


@pytest.fixture(scope="module")
def bf16_steps():
    """(JAX's metrics, the port's with bf16 logits, the port's with float32
    logits) of one output step from one JAX state, 64x64 batch 2."""
    batch = step_batches(1, 64, 2, seed=11)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL.Dropout, "__call__", lambda self, x, deterministic: x)
        jm = jax_build_method(JaxConfig(crop_size=64, base_size=64,
                                        batch_size=2, precision="f32",
                                        logits_dtype="bf16"),
                              iters_per_epoch=10, method="output_adapt")
        state = jm.init_state(jax.random.PRNGKey(0))
        params = _np(state.params)
        params["G"] = perturb_affine(params["G"])
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            params))
        start = (params, _np(state.batch_stats), _np(state.opt_state), 0)
        _, met = jax.jit(jm.step_fn)(state, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        want = {k: float(v) for k, v in met.items()}
    got = {}
    for logits in ("bf16", "f32"):
        pm = build_method(Config(precision="f32", logits_dtype=logits),
                          iters_per_epoch=10, method="output_adapt",
                          device="cpu")
        set_dropout(pm.deeplab, False)
        st = train_state_from_jax(pm.init_state(), *start)
        with torch_threads():
            _, m = pm.step_fn(st, batch)
        got[logits] = {k: float(v) for k, v in m.items()}
    return want, got["bf16"], got["f32"]


@pytest.mark.parametrize("key", ["seg_loss", "adv_loss", "d_loss"])
def test_bf16_logits_step_losses_match_jax(bf16_steps, key):
    want, got, f32 = bf16_steps
    np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    # the logits are bfloat16: the losses are not the float32 logits'
    np.testing.assert_allclose(got[key], f32[key], rtol=1e-4)
    assert got[key] != f32[key]
