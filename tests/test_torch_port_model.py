"""The port's DeepLab-V3+ (MobileNetV2, os 16, 19 classes, full width)
against the JAX package's: weight conversion key for key and value for
value, and the eval forward at 65x65, batch 2, float32 on the CPU.

Tolerance on logits: max|diff| <= 1e-4 * max(1, max|logit|) (float32 sums
in another order over ~60 layers; measured 1.1e-4 on logits of magnitude
10).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from s2r_tpu.io.torch_export import export_deeplab
from s2r_tpu_torch.io.convert import from_jax_variables
from s2r_tpu_torch.models.deeplab import DeepLab

from _torch_port_common import images, jax_deeplab, port_deeplab


@pytest.fixture(scope="module")
def models():
    jmodel, params, stats = jax_deeplab()
    return jmodel, params, stats, port_deeplab(params, stats)


def test_convert_matches_export_deeplab_key_for_key(models):
    _, params, stats, _ = models
    got = from_jax_variables(params, stats)
    want = export_deeplab(params, stats)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_port_state_dict_is_the_reference_schema(models):
    _, params, stats, model = models
    assert sorted(model.state_dict()) == sorted(export_deeplab(params, stats))


@pytest.mark.parametrize("upsample", [True, False])
def test_logits_match_jax(models, upsample):
    jmodel, params, stats, model = models
    x = images(seed=3)
    if not upsample:
        jmodel = jmodel.clone(upsample_logits=False)
    want, want_feat = jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), False)
    want, want_feat = np.asarray(want), np.asarray(want_feat)
    with torch.inference_mode():
        got, feat = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                          upsample_logits=upsample)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == ((2, 65, 65, 19) if upsample
                                       else (2, 17, 17, 19))
    assert got.dtype == np.float32
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(), want_feat,
                               rtol=0, atol=tol)


def test_taps_are_aspp_feature_and_low_level(models):
    _, _, _, model = models
    x = torch.from_numpy(images(n=1, seed=4)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feat, low = model.taps(x)
        _, feat2 = model(x)
    assert feat.shape == (1, 256, 5, 5) and low.shape == (1, 24, 17, 17)
    assert torch.equal(feat, feat2)


def test_bf16_forward_tracks_jax_bf16(models):
    """bfloat16 compute: activations stay bf16 and the logits follow JAX's
    bf16 forward.  The two frameworks round at other places, and through a
    random-weight network either bf16 forward lands ~15% of max|logit| from
    float32, so the bound is loose: 0.1 * max|logit| (measured 0.04)."""
    jmodel, params, stats, _ = models
    m16 = port_deeplab(params, stats, dtype="bf16")
    x = images(n=1, seed=5)
    want, _ = jmodel.clone(dtype=jnp.bfloat16).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    want = np.asarray(want, np.float32)
    with torch.inference_mode():
        got, feat = m16(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and feat.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()


def test_seeded_init_is_reproducible():
    a = DeepLab(device="cpu", generator=torch.Generator().manual_seed(7))
    b = DeepLab(device="cpu", generator=torch.Generator().manual_seed(7))
    c = DeepLab(device="cpu", generator=torch.Generator().manual_seed(8))
    wa, wb, wc = (m.decoder.last_conv[0].weight.detach()
                  for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    fan_in = 304 * 9
    assert abs(float(wa.std()) - (2.0 / fan_in) ** 0.5) < 0.05 * (2.0 / fan_in) ** 0.5


def test_default_device_without_gpu_raises(monkeypatch):
    """An entry point with no device asks for cuda; without a GPU it raises
    and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepLab()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepLab(device="cuda")
    assert DeepLab(device="cpu").device.type == "cpu"
