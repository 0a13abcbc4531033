"""The port's real-data slice against the JAX package's, on the CPU
(s2r_tpu/data/{transforms,datasets,hostcrop,loader}.py, cli/train*.py,
cli/val.py, cli/test*.py).

Fixtures are written by PIL under a temporary directory in the datasets'
layouts: GTA5-like sources 40x60 (RGB, P-mode labelIds with a palette) and
Cityscapes-like targets, val pairs (L-mode ``*_gtFine_labelIds.png``) and
test frames at 48x64, so source and target sizes differ.  From the same
``random.Random`` seeds:
- the three transform compositions and ``encode_segmap``: labels equal,
  images within 1e-6 after normalization (the port's uint8 samples go
  through ``device_aug.normalize_u8_batch``, JAX's through Normalize);
- ``TrainSet``/``ValSet``/``TestSet``/``GTA5``: names, splits, target
  pairing, staged frames, the cache and its byte cap;
- ``hostcrop.augment_sample``;
- ``make_data_loader`` batches for epochs 0 and 1 at 2 workers on the
  default host path, with --device-aug and with --data-cache, and the class
  weights (--use_balanced_weights) over a real train loader;
- ROADMAP C.9: the device warp maps a target of another size than its
  source through the target's own size (held against a float64 numpy
  reckoning of the map), where the JAX package reads it with the source's
  size, clamped (the same reckoning with the source's size reproduces
  JAX's output, and the two differ);
- the drivers at crop 32, float32: ``train --dataset gtav`` and
  ``train_adapt --dataset gtav2cityscapes`` one epoch each; ``val
  --dataset gtav`` within 1e-4 of the JAX package's ``cli.val`` on the same
  weights, handed over as a reference checkpoint; ``test_adapt`` writing
  one 1280x640 PNG pair per TestSet image, named from it.
"""

import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.data import datasets as JD
from s2r_tpu.data import device_aug as JA
from s2r_tpu.data import hostcrop as JH
from s2r_tpu.data import transforms as JT
from s2r_tpu.data.loader import make_data_loader as jax_loaders
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.data import datasets as PD
from s2r_tpu_torch.data import device_aug as PA
from s2r_tpu_torch.data import hostcrop as PH
from s2r_tpu_torch.data import transforms as PT
from s2r_tpu_torch.data.loader import make_data_loader

from _torch_port_common import torch_threads

SRC_HW, TGT_HW = (40, 60), (48, 64)
N_GTA, N_TGT, N_VAL, N_TEST = 10, 6, 4, 4


def _labelids(rs, hw):
    """Blocky raw Cityscapes labelIds (0..33) of size hw."""
    h, w = hw
    coarse = rs.randint(0, 34, (h // 4 + 1, w // 4 + 1)).astype(np.uint8)
    return np.kron(coarse, np.ones((4, 4), np.uint8))[:h, :w]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("real_data")
    r = {k: str(base / k) for k in ("src_img", "src_label", "tgt_img",
                                    "val_img", "val_label", "test_img")}
    for d in r.values():
        os.makedirs(d)
    rs = np.random.RandomState(0)
    palette = rs.randint(0, 256, 768).astype(np.uint8).tobytes()
    for i in range(N_GTA):
        Image.fromarray(rs.randint(0, 256, SRC_HW + (3,)).astype(np.uint8)
                        ).save(os.path.join(r["src_img"], f"{i:05d}.png"))
        lbl = Image.frombytes("P", SRC_HW[::-1],
                              _labelids(rs, SRC_HW).tobytes())
        lbl.putpalette(palette)
        lbl.save(os.path.join(r["src_label"], f"{i:05d}.png"))
    for split, n in (("tgt", N_TGT), ("val", N_VAL), ("test", N_TEST)):
        for i in range(n):
            stem = f"{split}_{i:06d}_000019_"
            Image.fromarray(rs.randint(0, 256, TGT_HW + (3,)).astype(
                np.uint8)).save(os.path.join(r[f"{split}_img"],
                                             stem + "leftImg8bit.png"))
            if split == "val":
                Image.fromarray(_labelids(rs, TGT_HW)).save(os.path.join(
                    r["val_label"], stem + "gtFine_labelIds.png"))
    return {"src_img_root": r["src_img"], "src_label_root": r["src_label"],
            "tgt_img_root": r["tgt_img"], "val_img_root": r["val_img"],
            "val_label_root": r["val_label"], "test_img_root": r["test_img"]}


def _assert_sample_equal(got, want):
    """Port uint8 sample against JAX's (PIL images, or normalized arrays)."""
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (str, list)):
            assert g == w, k
            continue
        w = np.asarray(w)
        if "label" in k or w.dtype == np.uint8:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert g.dtype == np.uint8, k
        norm = PA.normalize_u8_batch({k: torch.from_numpy(g)})[k].numpy()
        np.testing.assert_allclose(norm, w, rtol=0, atol=1e-6, err_msg=k)


def test_encode_segmap_matches_jax():
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(PD.encode_segmap(ids),
                                  JD.encode_segmap(ids))
    assert PD.CLASS_NAMES == JD.CLASS_NAMES
    assert PD.VALID_CLASSES == JD.VALID_CLASSES


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("comp", ["train", "eval", "val_scalecrop"])
def test_transforms_match_jax(roots, comp, seed):
    from s2r_tpu_torch.data import imaging

    name = f"{seed:05d}.png"
    src = imaging.load_rgb(os.path.join(roots["src_img_root"], name))
    lbl = PD.encode_segmap(imaging.load_raw(
        os.path.join(roots["src_label_root"], name)))
    tgt = imaging.load_rgb(sorted(
        os.path.join(roots["tgt_img_root"], f)
        for f in os.listdir(roots["tgt_img_root"]))[seed % N_TGT])
    if comp == "train":
        base, crop = [(32, 32), (24, 48), (40, 28)][seed % 3]
        p, j = PT.train_transforms(base, crop), JT.train_transforms(base, crop)
        sample = {"src_image": src, "tgt_image": tgt, "src_label": lbl}
    else:
        crop = 32 + seed
        p = getattr(PT, f"{comp}_transforms")(crop)
        j = getattr(JT, f"{comp}_transforms")(crop)
        sample = {"image": src, "label": lbl}
    got = p(dict(sample), random.Random(seed))
    want = j({k: Image.fromarray(v) for k, v in sample.items()},
             random.Random(seed))
    _assert_sample_equal(got, want)


def _sets(mod, roots, **kw):
    r = roots
    c = dict(base_size=32, crop_size=32)
    return {
        "train": mod.TrainSet(r["src_img_root"], r["src_label_root"],
                              r["tgt_img_root"], **c, **kw),
        "val": mod.ValSet(r["val_img_root"], r["val_label_root"], 32),
        "test": mod.TestSet(r["test_img_root"], "", 32),
        **{f"gta5_{s}": mod.GTA5(r["src_img_root"], r["src_label_root"], **c,
                                 split=s, **(kw if s == "train" else {}))
           for s in ("train", "val", "test")}}


@pytest.mark.parametrize("mode", ["host", "staged", "cache", "staged_cache"])
def test_datasets_match_jax(roots, mode):
    kw = {"staged": "staged" in mode, "cache": "cache" in mode}
    ps, js = _sets(PD, roots, **kw), _sets(JD, roots, **kw)
    assert len(ps["gta5_train"]) == 7 and len(ps["gta5_val"]) == 2
    for name in ps:
        p, j = ps[name], js[name]
        assert len(p) == len(j) > 0, name
        for attr in ("sources", "targets", "labels", "images", "files"):
            assert getattr(p, attr, None) == getattr(j, attr, None), name
        for i in range(len(p)):
            for _ in range(2 if kw["cache"] else 1):  # the second one hits
                _assert_sample_equal(p.__getitem__(i, rng=random.Random(i)),
                                     j.__getitem__(i, rng=random.Random(i)))
    for name in ("train", "gta5_train"):
        pc, jc = ps[name].cache, js[name].cache
        assert (pc is None) == (jc is None) == (not kw["cache"])
        if pc is not None:
            assert pc.nbytes() == jc.nbytes() > 0
            assert pc.hits > 0 and pc.misses == len(pc._d)


def test_frame_cache_byte_cap(roots):
    """Frames past the cap are not kept (and decode on every access)."""
    frame = 40 * 60 * 3
    cap = 2 * frame + 40 * 60  # two images and a label
    p = PD.TrainSet(roots["src_img_root"], roots["src_label_root"],
                    roots["tgt_img_root"], 32, 32, staged=True, cache=True,
                    cache_bytes=cap)
    j = JD.TrainSet(roots["src_img_root"], roots["src_label_root"],
                    roots["tgt_img_root"], 32, 32, staged=True, cache=True,
                    cache_bytes=cap)
    for _ in range(2):
        for i in range(len(p)):
            _assert_sample_equal(p.__getitem__(i, rng=random.Random(i)),
                                 j.__getitem__(i, rng=random.Random(i)))
    assert p.cache.nbytes() == j.cache.nbytes() <= cap
    assert p.cache.misses > len(p.cache._d)


@pytest.mark.parametrize("seed", range(8))
def test_hostcrop_matches_jax(roots, seed):
    from s2r_tpu_torch.data import imaging

    name = f"{seed % N_GTA:05d}.png"
    sample = {"src_image": imaging.load_rgb(
                  os.path.join(roots["src_img_root"], name)),
              "tgt_image": imaging.load_rgb(os.path.join(
                  roots["val_img_root"], sorted(os.listdir(
                      roots["val_img_root"]))[seed % N_VAL])),
              "src_label": PD.encode_segmap(imaging.load_raw(
                  os.path.join(roots["src_label_root"], name)))}
    base, crop = [(32, 32), (20, 44), (64, 24), (40, 40)][seed % 4]
    got = PH.augment_sample(dict(sample), random.Random(seed), base, crop)
    want = JH.augment_sample(dict(sample), random.Random(seed), base, crop)
    _assert_sample_equal(got, want)


LOADER_CASES = [("gtav2cityscapes", {}), ("gtav2cityscapes",
                                         {"device_aug": True}),
                ("gtav2cityscapes", {"data_cache": True}),
                ("gtav", {}), ("gtav", {"device_aug": True}),
                ("gtav", {"data_cache": True})]


@pytest.mark.parametrize("dataset,kw", LOADER_CASES)
def test_loader_batches_match_jax(roots, dataset, kw):
    cfg = dict(dataset=dataset, batch_size=2, crop_size=32, base_size=32,
               workers=2, **roots, **kw)
    p_all, j_all = make_data_loader(Config(**cfg)), jax_loaders(
        JaxConfig(**cfg))
    for split in range(3):
        p, j = p_all[split], j_all[split]
        assert len(p) == len(j)
        for epoch in ((0, 1) if split == 0 else (0,)):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            pb, jb = list(p), list(j)
            assert len(pb) == len(jb) == len(p)
            for g, w in zip(pb, jb):
                _assert_sample_equal(g, w)


@pytest.mark.parametrize("dataset", ["gtav", "gtav2cityscapes"])
def test_class_weights_over_real_loader(roots, dataset, tmp_path):
    from s2r_tpu.utils.calculate_weights import calculate_weights_labels as jw
    from s2r_tpu_torch.utils.calculate_weights import calculate_weights_labels

    cfg = dict(dataset=dataset, batch_size=2, crop_size=32, base_size=32,
               workers=2, **roots)
    want = jw(jax_loaders(JaxConfig(**cfg))[0], 19, str(tmp_path / "j.npy"),
              dataset)
    got = calculate_weights_labels(make_data_loader(Config(**cfg))[0], 19,
                                   str(tmp_path / "p.npy"), dataset)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- C.9 ---

def _params(key, n, base, crop, sh, sw):
    """The parameters JAX's augment_paired_batch draws for each sample."""
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


def _reckon(frame, p, crop, fh, fw):
    """float64 numpy: the crop of `frame` (uint8 [N, H, W, 3]) under the
    pair's parameters when the map reads it as an fh x fw frame (indices
    clamped to fh, fw as JAX's gather clamps), normalized, no blur."""
    n = frame.shape[0]
    h, w = frame.shape[1:3]
    out = np.zeros((n, crop, crop, 3))
    for s in range(n):
        oh, ow = float(p["oh"][s]), float(p["ow"][s])
        ys = float(p["y1"][s]) + np.arange(crop)
        xs = float(p["x1"][s]) + np.arange(crop)
        sy = (ys + 0.5) * fh / oh - 0.5
        sx = (xs + 0.5) * fw / ow - 0.5
        if bool(p["flip"][s]):
            sx = (fw - 1.0) - sx
        y0 = np.clip(np.floor(sy), 0, fh - 1)
        x0 = np.clip(np.floor(sx), 0, fw - 1)
        y1 = np.clip(y0 + 1, 0, fh - 1)
        x1 = np.clip(x0 + 1, 0, fw - 1)
        wy = np.clip(sy - y0, 0, 1)[:, None, None]
        wx = np.clip(sx - x0, 0, 1)[None, :, None]
        f = frame[s].astype(np.float64)
        ri = [np.minimum(r.astype(int), h - 1) for r in (y0, y1)]
        ci = [np.minimum(c.astype(int), w - 1) for c in (x0, x1)]
        row = f[ri[0]] * (1 - wy) + f[ri[1]] * wy
        img = row[:, ci[0]] * (1 - wx) + row[:, ci[1]] * wx
        inside = (ys[:, None] < oh) & (xs[None, :] < ow)
        out[s] = np.where(inside[..., None], img, 0.0)
    mean, std = np.asarray(JT.IMAGENET_MEAN), np.asarray(JT.IMAGENET_STD)
    return (out / 255.0 - mean) / std


@pytest.mark.parametrize("src_hw,tgt_hw", [((40, 60), (48, 64)),
                                           ((48, 64), (40, 60)),
                                           ((44, 52), (44, 52))])
def test_c9_target_warped_from_its_own_size(src_hw, tgt_hw):
    n, base, crop = 6, 32, 32
    rs = np.random.RandomState(sum(src_hw + tgt_hw))
    batch = {"src_image": rs.randint(0, 256, (n,) + src_hw + (3,)),
             "tgt_image": rs.randint(0, 256, (n,) + tgt_hw + (3,)),
             "src_label": rs.randint(0, 19, (n,) + src_hw)}
    batch = {k: v.astype(np.uint8) for k, v in batch.items()}
    key = jax.random.PRNGKey(sum(tgt_hw))
    params = _params(key, n, base, crop, *src_hw)
    got = PA.warp_paired_batch({k: torch.from_numpy(v) for k, v in
                                batch.items()}, params, crop, blur=False)
    want = JA.augment_paired_batch({k: jnp.asarray(v) for k, v in
                                    batch.items()}, key, base, crop, False)
    jax_tgt = np.asarray(want["tgt_image"])
    # the source and its labels: the JAX package's, as before
    np.testing.assert_allclose(got["src_image"].numpy(),
                               np.asarray(want["src_image"]), atol=1e-4)
    np.testing.assert_array_equal(got["src_label"].numpy(),
                                  np.asarray(want["src_label"]))
    # the target: its own size's map, float64
    np.testing.assert_allclose(got["tgt_image"].numpy(),
                               _reckon(batch["tgt_image"], params, crop,
                                       *tgt_hw), atol=1e-4)
    # JAX reads the target with the source's size, clamped
    np.testing.assert_allclose(jax_tgt, _reckon(batch["tgt_image"], params,
                                                crop, *src_hw), atol=1e-4)
    diff = np.abs(got["tgt_image"].numpy() - jax_tgt).max()
    if src_hw == tgt_hw:
        assert diff <= 1e-4
    else:
        assert diff > 0.5


# -------------------------------------------------------------- drivers ---

ARGV = ["--batch-size", "2", "--crop-size", "32", "--base-size", "32",
        "--precision", "f32", "--workers", "2", "--epochs", "1"]


def _argv(roots, dataset):
    out = ["--dataset", dataset] + ARGV
    for k, v in roots.items():
        out += [f"--{k}", v]
    return out


def _fit(main, argv, root):
    mp = pytest.MonkeyPatch()
    mp.setenv("S2R_PLATFORM", "cpu")
    try:
        with torch_threads():
            trainer = main(argv + ["--run-root", str(root)])
    finally:
        mp.undo()
    path = trainer.saver.save_checkpoint(trainer.state, 1, trainer.best_pred,
                                         is_best=False, filename="final.ckpt")
    trainer.saver.wait()
    return trainer, path


def _scalars(trainer):
    path = os.path.join(trainer.saver.experiment_dir, "scalars.jsonl")
    return {r["tag"]: r["value"] for r in map(json.loads, open(path))}


def test_cli_train_gtav_and_val_match_jax(roots, tmp_path, monkeypatch):
    from s2r_tpu.cli import val as jax_val
    from s2r_tpu_torch.cli import train, val

    argv = _argv(roots, "gtav")
    trainer, path = _fit(train.main, argv, tmp_path / "run")
    assert trainer.method.name == "source_only"
    assert trainer.state.step == len(trainer.train_loader) == 3
    tags = _scalars(trainer)
    assert np.isfinite(tags["train/task_loss"]) and 0 <= tags["val/mIoU"] <= 1
    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    with torch_threads():
        miou, _ = val.main(argv + ["--resume", path, "--skip-sep",
                                   "--out-dir", str(tmp_path / "port")])
    assert abs(miou - tags["val/mIoU"]) <= 1e-6
    ref = str(tmp_path / "port.pth.tar")
    torch.save({"state_dict": trainer.state.G.state_dict(), "epoch": 1,
                "best_pred": trainer.best_pred}, ref)
    want, _ = jax_val.main(argv + ["--resume", ref, "--skip-sep",
                                   "--out-dir", str(tmp_path / "jax")])
    assert abs(miou - want) <= 1e-4, (miou, want)


def test_cli_train_adapt_and_test_on_real_roots(roots, tmp_path,
                                                monkeypatch):
    from s2r_tpu_torch.cli import test_adapt, train_adapt

    argv = _argv(roots, "gtav2cityscapes")
    trainer, path = _fit(train_adapt.main, argv, tmp_path / "run")
    assert trainer.method.name == "output_adapt"
    assert trainer.state.step == len(trainer.train_loader) == N_GTA // 2
    tags = _scalars(trainer)
    for k in ("train/seg_loss", "train/adv_loss", "train/d_loss"):
        assert np.isfinite(tags[k]), k
    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    out = tmp_path / "test"
    with torch_threads():
        test_adapt.main(argv + ["--resume", path, "--out-dir", str(out)])
    stems = sorted(f[:-len(".png")] for f in os.listdir(
        roots["test_img_root"]))
    assert sorted(os.listdir(out)) == sorted(
        [f"{s}_labelId.png" for s in stems]
        + [f"{s}_color.png" for s in stems])
    for f in os.listdir(out):
        assert Image.open(out / f).size == (1280, 640)


def test_frame_cache_threads_decode_each_frame_once():
    """More threads than cores on a few frames, the interpreter switching
    often: each frame decodes once, every lookup gets its array."""
    import sys
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    cache = PD._FrameCache()
    decodes, lock = {}, threading.Lock()

    def load(path):
        with lock:
            decodes[path] = decodes.get(path, 0) + 1
        time.sleep(0.002)
        return np.full(3, int(path), np.uint8)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            keys = [str(i % 5) for i in range(400)]
            got = list(pool.map(lambda k: cache.get(k, load), keys))
    finally:
        sys.setswitchinterval(old)
    assert all(int(g[0]) == int(k) for g, k in zip(got, keys))
    assert decodes == {str(i): 1 for i in range(5)}
    assert cache.misses == 5 and cache.hits == 395
