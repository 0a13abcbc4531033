"""The port's data path against the JAX package's (s2r_tpu/data/synthetic.py,
loader.py, device_aug.py, transforms.py eval transforms), on the CPU.

- Synthetic scenes and samples: bit-equal.
- With --device-aug, the train loader's batches (order and uint8 content)
  are bit-equal to JAX's make_data_loader for epochs 0 and 1.
- The port's eval batches, normalized on the device, within 1e-6 of JAX's
  PIL eval batches (FixScaleCrop + Normalize); labels equal.
- The port's warp, fed the parameters JAX's _warp_one draws (the same
  jax.random.split of the key), within 1e-4 of augment_paired_batch and
  equal on labels, with the blur on and off.
- The port's sampler stays inside JAX's ranges over many draws.
- normalize_u8_batch within 1e-7 of JAX's.
- --data-backend native takes the native loaders for gtav2cityscapes
  (gtav and synthetic ignore it, as the JAX package does); the synthetic
  train set without --device-aug (the host transforms) gives JAX's
  batches.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.data import device_aug as JA
from s2r_tpu.data import synthetic as JS
from s2r_tpu.data.loader import make_data_loader as jax_loaders
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.data import device_aug as PA
from s2r_tpu_torch.data import synthetic as PS
from s2r_tpu_torch.data.loader import make_data_loader

KW = dict(dataset="synthetic", device_aug=True, batch_size=2, crop_size=24,
          base_size=24, workers=2)


@pytest.mark.parametrize("seed,h,w", [(0, 24, 24), (7, 33, 17)])
def test_scene_bit_equal(seed, h, w):
    ji, jl = JS._scene(np.random.RandomState(seed), h, w)
    pi, pl = PS._scene(np.random.RandomState(seed), h, w)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pl, jl)
    assert pi.dtype == ji.dtype and pl.dtype == jl.dtype


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_loader_bit_equal(epoch):
    jt = jax_loaders(JaxConfig(**KW))[0]
    pt = make_data_loader(Config(**KW))[0]
    assert len(pt) == len(jt)
    jt.set_epoch(epoch)
    pt.set_epoch(epoch)
    _assert_batches_equal(list(pt), list(jt))


def test_train_loader_epochs_differ():
    pt = make_data_loader(Config(**KW))[0]
    first = [b["src_image"] for b in pt]
    pt.set_epoch(1)
    second = [b["src_image"] for b in pt]
    assert any(not np.array_equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("split", [1, 2])
def test_eval_batches_match_pil(split):
    """The JAX eval set at crop x crop: FixScaleCrop is an identity resize
    and crop, so Normalize on the host equals the port's normalization on
    the device."""
    cfg = dict(KW, device_aug=False, batch_size=3)
    jl = jax_loaders(JaxConfig(**cfg))[split]
    pl = make_data_loader(Config(**cfg))[split]
    j_batches, p_batches = list(jl), list(pl)
    assert len(p_batches) == len(j_batches) > 0
    for p, j in zip(p_batches, j_batches):
        assert p["image"].dtype == np.uint8 and p["label"].dtype == np.uint8
        out = PA.normalize_u8_batch({k: torch.as_tensor(v) for k, v in
                                     p.items() if not isinstance(v, list)})
        np.testing.assert_allclose(out["image"].numpy(), j["image"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["label"].numpy(), j["label"])
        assert p["name"] == j["name"]


def _staged(n, h, w, seed=0):
    rs = np.random.RandomState(seed)
    return {"src_image": rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
            "tgt_image": rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
            "src_label": rs.randint(0, 20, (n, h, w)).astype(np.uint8)}


def _jax_params(key, n, base, crop, sh, sw):
    """The parameters augment_paired_batch draws for each sample."""
    out = {k: [] for k in ("flip", "oh", "ow", "y1", "x1", "blur_gate",
                           "radius")}
    for kk in jax.random.split(key, n):
        k_geom, k_gate, k_r1, k_r2 = jax.random.split(kk, 4)
        flip, oh, ow, y1, x1 = JA._sample_params(k_geom, base, crop, sh, sw)
        for name, v in zip(("flip", "oh", "ow", "y1", "x1"),
                           (flip, oh, ow, y1, x1)):
            out[name].append(np.asarray(v))
        out["blur_gate"].append(np.asarray(jax.random.bernoulli(k_gate, 0.5)))
        out["radius"].append([np.asarray(jax.random.uniform(k_r1, ())),
                              np.asarray(jax.random.uniform(k_r2, ()))])
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("blur", [True, False])
@pytest.mark.parametrize("key,hw,base,crop", [(0, (40, 56), 32, 32),
                                              (1, (48, 30), 20, 36),
                                              (2, (32, 32), 32, 24)])
def test_warp_matches_jax(blur, key, hw, base, crop):
    n = 6
    batch = _staged(n, *hw, seed=key)
    rng = jax.random.PRNGKey(key)
    want = JA.augment_paired_batch({k: jnp.asarray(v) for k, v in
                                    batch.items()}, rng, base, crop, blur)
    params = _jax_params(rng, n, base, crop, *hw)
    got = PA.warp_paired_batch({k: torch.from_numpy(v) for k, v in
                                batch.items()}, params, crop, blur)
    for k in ("src_image", "tgt_image"):
        assert got[k].shape == (n, crop, crop, 3) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["src_label"].numpy(),
                                  np.asarray(want["src_label"]))
    if blur:  # both gate values and padding occur across the cases
        assert params["blur_gate"].any()


def test_warp_single_domain_matches_paired():
    batch = _staged(3, 30, 40, seed=3)
    params = PA.sample_params(torch.Generator().manual_seed(0), 3, 24, 28,
                              30, 40)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    paired = PA.warp_paired_batch(t, params, 28)
    single = PA.warp_batch({"image": t["src_image"], "label": t["src_label"]},
                           params, 28)
    assert torch.equal(single["image"], paired["src_image"])
    assert torch.equal(single["label"], paired["src_label"])


@pytest.mark.parametrize("sh,sw", [(64, 64), (80, 50), (50, 80)])
def test_sampler_inside_jax_ranges(sh, sw):
    base, (ch, cw), n = 32, (48, 40), 4000
    p = PA.sample_params(torch.Generator().manual_seed(1), n, base, (ch, cw),
                         sh, sw)
    short = p["ow"] if sh > sw else p["oh"]
    long_ = p["oh"] if sh > sw else p["ow"]
    assert int(short.min()) == base // 2 and int(short.max()) == 2 * base
    np.testing.assert_array_equal(
        long_.numpy(), np.floor(np.float32(max(sh, sw)) * short.numpy()
                                / np.float32(min(sh, sw))))
    for c, o, k in ((ch, p["oh"], "y1"), (cw, p["ow"], "x1")):
        slack = torch.clamp(o, min=float(c)) - c
        assert (p[k] >= 0).all() and (p[k] <= slack).all()
        assert (p[k] == torch.floor(p[k])).all()
    for k in ("flip", "blur_gate"):
        frac = float(p[k].float().mean())
        assert 0.45 < frac < 0.55, (k, frac)
    assert (p["radius"] >= 0).all() and (p["radius"] < 1).all()
    # JAX's draws over as many keys lie in the same ranges
    keys = jax.random.split(jax.random.PRNGKey(0), 500)
    jp = jax.vmap(lambda k: JA._sample_params(k, base, (ch, cw), sh, sw))(keys)
    j_short = np.asarray(jp[2] if sh > sw else jp[1])
    assert base // 2 <= j_short.min() and j_short.max() <= 2 * base


def test_batch_generator_is_deterministic():
    a = PA.sample_params(PA.batch_generator(1, 3, 5), 4, 32, 32, 40, 40)
    b = PA.sample_params(PA.batch_generator(1, 3, 5), 4, 32, 32, 40, 40)
    c = PA.sample_params(PA.batch_generator(1, 3, 6), 4, 32, 32, 40, 40)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_normalize_u8_batch_matches_jax():
    rs = np.random.RandomState(4)
    batch = {"image": rs.randint(0, 256, (2, 9, 7, 3)).astype(np.uint8),
             "label": rs.randint(0, 256, (2, 9, 7)).astype(np.uint8)}
    want = JA.normalize_u8_batch({k: jnp.asarray(v) for k, v in batch.items()})
    got = PA.normalize_u8_batch({k: torch.from_numpy(v) for k, v in
                                 batch.items()})
    assert got["image"].dtype == torch.float32
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got["label"].numpy(),
                                  np.asarray(want["label"]))


def test_unported_datasets_raise(tmp_path):
    """Every dataset loads now, on either backend.  --data-backend native
    takes the native loaders for gtav2cityscapes, the one arm where the
    JAX package has them (their batches: test_torch_port_native_loader.py);
    gtav and synthetic ignore the flag and load the same batches as
    without it, as in the JAX package.  The synthetic train set without
    --device-aug goes through the host train transforms: its uint8 crops,
    normalized, are JAX's PIL batches."""
    from s2r_tpu_torch.data.native_loader import NativeEvalLoader, \
        NativeTrainLoader
    from s2r_tpu_torch.utils.png import write_png

    rs = np.random.RandomState(3)
    roots = {"src_img_root": str(tmp_path / "img"),
             "src_label_root": str(tmp_path / "lbl")}
    for d in roots.values():
        os.makedirs(d)
    for i in range(20):  # GTA5's 70/20/10 split: 7, 2 and 1 batches
        write_png(os.path.join(roots["src_img_root"], f"{i:05d}.png"),
                  rs.randint(0, 256, (30, 40, 3)).astype(np.uint8))
        write_png(os.path.join(roots["src_label_root"], f"{i:05d}.png"),
                  rs.randint(0, 34, (30, 40)).astype(np.uint8))
    city = {k: str(tmp_path / k) for k in ("tgt_img_root", "val_img_root",
                                           "val_label_root", "test_img_root")}
    for k, d in city.items():
        os.makedirs(d)
        stem = os.path.join(d, "a_000000_000019_")
        write_png(stem + ("gtFine_labelIds.png" if k == "val_label_root"
                          else "leftImg8bit.png"),
                  rs.randint(0, 34 if k == "val_label_root" else 256,
                             (30, 40) if k == "val_label_root"
                             else (30, 40, 3)).astype(np.uint8))
    cfg = dict(KW, dataset="gtav2cityscapes", data_backend="native",
               device_aug=False, **roots, **city)
    got = make_data_loader(Config(**cfg))
    want = jax_loaders(JaxConfig(**cfg))
    assert [type(g) for g in got[:3]] == [NativeTrainLoader, NativeEvalLoader,
                                          NativeEvalLoader]
    assert [type(w).__name__ for w in want[:3]] == [
        "NativeTrainLoader", "NativeEvalLoader", "NativeEvalLoader"]
    assert [len(g) for g in got[:3]] == [len(w) for w in want[:3]]
    for name, extra in (("gtav", roots), ("synthetic", {})):
        plain = dict(KW, dataset=name, **extra)
        for split in range(3):
            got = make_data_loader(Config(**dict(plain,
                                                 data_backend="native")))
            want = make_data_loader(Config(**plain))
            want_j = jax_loaders(JaxConfig(**dict(plain,
                                                  data_backend="native")))
            assert len(got[split]) == len(want[split]) == len(want_j[split])
            _assert_batches_equal(list(got[split]), list(want[split]))
    cfg = dict(KW, device_aug=False)
    got = next(iter(make_data_loader(Config(**cfg))[0]))
    want = next(iter(jax_loaders(JaxConfig(**cfg))[0]))
    assert got["src_image"].dtype == np.uint8
    out = PA.normalize_u8_batch({k: torch.as_tensor(v)
                                 for k, v in got.items()})
    for k in ("src_image", "tgt_image"):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["src_label"].numpy(), want["src_label"])


def test_class_weights_match_jax(tmp_path):
    from s2r_tpu.utils.calculate_weights import calculate_weights_labels as jw
    from s2r_tpu_torch.utils.calculate_weights import calculate_weights_labels

    want = jw(jax_loaders(JaxConfig(**KW))[0], 19, str(tmp_path / "j.npy"),
              "synthetic")
    got = calculate_weights_labels(make_data_loader(Config(**KW))[0], 19,
                                   str(tmp_path / "p.npy"), "synthetic")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), want)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 9)])
def test_png_encoder_round_trips(tmp_path, shape):
    from PIL import Image

    from s2r_tpu_torch.utils.png import write_png

    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")),
                                  img)


def test_prefetch_on_the_cpu_converts_and_passes_names():
    from s2r_tpu_torch.parallel.feed import prefetch_to_device

    loader = make_data_loader(Config(**dict(KW, device_aug=False)))[1]
    want = list(loader)
    got = list(prefetch_to_device(loader, "cpu"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        assert torch.equal(g["image"], torch.from_numpy(w["image"]))
        assert torch.equal(g["label"], torch.from_numpy(w["label"]))
