"""The port's make_serving_fn against the JAX package's, exact mode, at
65x65, batch 2, float32 on the CPU: every output / argmax_res /
label_dtype combination, the rgb8 ingest and batch padding; and the same
argument validation.

Logits and probabilities agree within tol = 1e-4 * max(1, max|ref|) (the
model test's bound).  Labels are equal at every pixel whose top two JAX
logits are more than 2 * tol apart; a pixel closer than that is a float
near-tie that either framework may break either way.  Near-ties must stay
under 1% of the pixels (0.12% on the full-res inputs here: the upsampled
logits cross smoothly at class boundaries), and the labels must agree on
at least 99.9% of all pixels (one pixel in 8450 differs here, its two
logits 4e-5 apart).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from s2r_tpu.io.serving import _nearest_ac_indices as jax_nearest
from s2r_tpu.io.serving import make_serving_fn as jax_serving_fn
from s2r_tpu_torch.io.serving import _nearest_ac_indices, make_serving_fn

from _torch_port_common import images, jax_deeplab, port_deeplab


@pytest.fixture(scope="module")
def models():
    jmodel, params, stats = jax_deeplab()
    return jmodel, params, stats, port_deeplab(params, stats)


def _both(models, image, **kw):
    jmodel, params, stats, model = models
    want = np.asarray(jax_serving_fn(jmodel, params, stats, **kw)(
        jnp.asarray(image)))
    got = make_serving_fn(model, **kw)(image).numpy()
    return got, want


@pytest.mark.parametrize("kw", [
    dict(output="labels"),
    dict(output="labels", label_dtype="uint8"),
    dict(output="labels", argmax_res="decoder"),
    dict(output="labels", argmax_res="decoder", label_dtype="uint8"),
    dict(output="labels", input="rgb8"),
    dict(output="labels", argmax_res="decoder", pad_batch_to=3),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_labels_equal_jax(models, kw):
    if kw.get("input") == "rgb8":
        image = np.random.RandomState(7).randint(0, 256, (2, 65, 65, 3),
                                                 np.uint8)
    else:
        image = images(seed=6)
    got, want = _both(models, image, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 65, 65)
    decisive = _decisive(models, image, kw)
    assert decisive.mean() >= 0.99
    np.testing.assert_array_equal(got[decisive], want[decisive])
    assert (got == want).mean() >= 0.999


def _decisive(models, image, kw):
    """Pixels whose top two JAX logits (where the argmax is taken) are more
    than 2 * tol apart."""
    jmodel, params, stats, _ = models
    if kw.get("argmax_res") == "decoder":
        dec = jmodel.clone(upsample_logits=False)
        logits = np.asarray(dec.apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(image), False)[0])
    else:
        logits = np.asarray(jax_serving_fn(
            jmodel, params, stats, output="logits",
            input=kw.get("input", "normalized"))(jnp.asarray(image)))
    tol = 1e-4 * max(1.0, float(np.abs(logits).max()))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    mask = top2[..., 1] - top2[..., 0] > 2 * tol
    if kw.get("argmax_res") == "decoder":
        rows = jax_nearest(image.shape[1], mask.shape[1])
        cols = jax_nearest(image.shape[2], mask.shape[2])
        mask = mask[:, rows][:, :, cols]
    return mask


@pytest.mark.parametrize("output", ["logits", "probs"])
def test_logits_and_probs_match_jax(models, output):
    got, want = _both(models, images(seed=8), output=output,
                      pad_batch_to=2)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 65, 65, 19)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_nearest_indices_match_jax():
    for out_size, in_size in [(65, 17), (1024, 256), (513, 129), (1, 5)]:
        np.testing.assert_array_equal(_nearest_ac_indices(out_size, in_size),
                                      jax_nearest(out_size, in_size))


@pytest.mark.parametrize("kw", [
    dict(pad_batch_to=0),
    dict(quant="int4"),
    dict(quant="decoder_int8"),
    dict(quant="decoder_int8", quant_scales={"a0": 1.0}),
    dict(output="features"),
    dict(argmax_res="half"),
    dict(argmax_res="decoder", output="logits"),
    dict(label_dtype="int16"),
    dict(label_dtype="uint8", output="probs"),
])
def test_validation_matches_jax(models, kw):
    jmodel, params, stats, model = models
    with pytest.raises(ValueError):
        jax_serving_fn(jmodel, params, stats, **kw)
    with pytest.raises(ValueError):
        make_serving_fn(model, **kw)


def test_batch_over_pad_raises(models):
    fn = make_serving_fn(models[3], pad_batch_to=1)
    with pytest.raises(ValueError, match="exceeds"):
        fn(images(seed=9))


def test_serving_keeps_no_autograd_state(models):
    out = make_serving_fn(models[3], output="logits")(images(n=1, seed=10))
    assert not out.requires_grad and out.device.type == "cpu"
    assert isinstance(out, torch.Tensor)
