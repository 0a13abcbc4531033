"""The port's native loaders (data/native_loader.py) and the native route
through make_data_loader, the Trainer and the drivers, against the JAX
package's (s2r_tpu/data/native_loader.py, data/loader.py:140-167,
train/trainer.py:262-285), on the CPU; and ``--profile-dir``.

Fixtures: GTA5-like sources 40x60 with L-mode labelIds (and a P-mode copy
of the same indices), Cityscapes-like targets, val pairs and test frames
at 48x64.
- NativeTrainLoader and NativeEvalLoader give JAX's batches in the same
  order over epochs 0 and 1, at process_count 1 and 2 (both ranks): labels
  and names equal, images within the bounds of test_torch_port_native.py
  (float32 within an ulp; a blurred image's bytes within one in at most
  1e-4 of its elements).  ``len()`` equals the batches an epoch gives; the
  JAX NativeEvalLoader also counts a ragged tail its ranks drop (ROADMAP
  C.11).
- make_data_loader(data_backend="native") builds the native loaders for
  gtav2cityscapes with JAX's paths, thread count and batches.  On P-mode
  labels the port's batches are those of the L-mode copy; JAX's differ
  (ROADMAP C.12).
- train_adapt one epoch on the native route (finite losses, mIoU in
  [0, 1]), then test_adapt through NativeEvalLoader writing one PNG pair a
  test frame; train, val (the Trainer's mIoU) and test likewise.
- --device-aug on the native route warps the native batch once more, as
  the JAX Trainer does (ROADMAP C.13): the port's warp fed JAX's sampled
  parameters is JAX's augment_paired_batch within 1e-4, labels equal.
- --profile-dir: a fit writes one trace file there; without it, none.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.data import device_aug as JA
from s2r_tpu.data import native_loader as JL
from s2r_tpu.data.loader import make_data_loader as jax_loaders
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.data import device_aug as PA
from s2r_tpu_torch.data import native_loader as PL
from s2r_tpu_torch.data.loader import make_data_loader

from _torch_port_common import torch_threads
from test_torch_port_data import _jax_params
from test_torch_port_native import _assert_close

SRC_HW, TGT_HW = (40, 60), (48, 64)
N_GTA, N_TGT, N_VAL, N_TEST = 10, 6, 5, 4
KW = dict(dataset="gtav2cityscapes", data_backend="native", batch_size=2,
          crop_size=32, base_size=32, workers=2)


def _labelids(rs, hw):
    h, w = hw
    coarse = rs.randint(0, 34, (h // 4 + 1, w // 4 + 1)).astype(np.uint8)
    return np.kron(coarse, np.ones((4, 4), np.uint8))[:h, :w]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{'L': roots with L-mode GTA5 labels, 'P': the same with P-mode}."""
    base = tmp_path_factory.mktemp("native_roots")
    r = {k: str(base / k) for k in ("src_img", "src_label", "src_label_p",
                                    "tgt_img", "val_img", "val_label",
                                    "test_img")}
    for d in r.values():
        os.makedirs(d)
    rs = np.random.RandomState(0)
    palette = rs.randint(0, 256, 768).astype(np.uint8).tolist()
    for i in range(N_GTA):
        name = f"{i:05d}.png"
        Image.fromarray(rs.randint(0, 256, SRC_HW + (3,)).astype(np.uint8)
                        ).save(os.path.join(r["src_img"], name))
        lbl = _labelids(rs, SRC_HW)
        Image.fromarray(lbl, "L").save(os.path.join(r["src_label"], name))
        p = Image.fromarray(lbl, "P")
        p.putpalette(palette)
        p.save(os.path.join(r["src_label_p"], name))
    for split, n in (("tgt", N_TGT), ("val", N_VAL), ("test", N_TEST)):
        for i in range(n):
            stem = f"{split}_{i:06d}_000019_"
            Image.fromarray(rs.randint(0, 256, TGT_HW + (3,)).astype(
                np.uint8)).save(os.path.join(r[f"{split}_img"],
                                             stem + "leftImg8bit.png"))
            if split == "val":
                Image.fromarray(_labelids(rs, TGT_HW)).save(os.path.join(
                    r["val_label"], stem + "gtFine_labelIds.png"))
    common = {"tgt_img_root": r["tgt_img"], "val_img_root": r["val_img"],
              "val_label_root": r["val_label"],
              "test_img_root": r["test_img"], "src_img_root": r["src_img"]}
    return {"L": dict(common, src_label_root=r["src_label"]),
            "P": dict(common, src_label_root=r["src_label_p"])}


def _assert_batches_close(got, want, blurred):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k]
            else:
                _assert_close(g[k], w[k], blurred and "image" in k)


def _train_pair(roots, **kw):
    from s2r_tpu_torch.data.datasets import recursive_glob
    srcs = recursive_glob(roots["src_img_root"], ".png")
    tgts = recursive_glob(roots["tgt_img_root"], ".png")
    args = (srcs, roots["src_label_root"], tgts, 32, (24, 40), 4)
    return PL.NativeTrainLoader(*args, **kw), JL.NativeTrainLoader(*args,
                                                                    **kw)


@pytest.mark.parametrize("emit_u8", [False, True])
@pytest.mark.parametrize("count", [1, 2])
def test_train_loader_matches_jax(roots, count, emit_u8):
    for rank in range(count):
        got, want = _train_pair(roots["L"], seed=3, threads=2,
                                emit_u8=emit_u8, process_index=rank,
                                process_count=count)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            g, w = list(got), list(want)
            assert len(g) == len(got) == len(want) == N_GTA // 4
            assert all(b["src_image"].shape[0] == 4 // count for b in g)
            _assert_batches_close(g, w, blurred=True)
    a, _ = _train_pair(roots["L"], seed=3)
    e0 = next(iter(a))
    a.set_epoch(1)
    assert not np.array_equal(next(iter(a))["src_label"], e0["src_label"])


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("count", [1, 2])
def test_eval_loaders_match_jax(roots, count, drop_last):
    """Val (labelled) and test (unlabelled) batches; 5 val images in
    batches of 2 leave a ragged tail of one."""
    from s2r_tpu_torch.data.datasets import recursive_glob
    r = roots["L"]
    labels = recursive_glob(r["val_label_root"], "gtFine_labelIds.png")
    imgs = [os.path.join(r["val_img_root"], os.path.basename(p)[:-len(
        "gtFine_labelIds.png")] + "leftImg8bit.png") for p in labels]
    tests = recursive_glob(r["test_img_root"], ".png")
    for paths, lbls in ((imgs, labels), (tests, None)):
        for rank in range(count):
            kw = dict(drop_last=drop_last, threads=2, process_index=rank,
                      process_count=count)
            got = PL.NativeEvalLoader(paths, lbls, 24, 2, **kw)
            want = JL.NativeEvalLoader(paths, lbls, 24, 2, **kw)
            g = list(got)
            _assert_batches_close(g, list(want), blurred=False)
            assert len(got) == len(g)
            ragged = len(paths) % 2 and not drop_last
            assert len(want) == len(g) + (1 if ragged and count == 2
                                          else 0)
            if lbls is None:
                assert all((b["label"] == 255).all() for b in g)


def test_make_data_loader_native_matches_jax(roots):
    cfg = dict(KW, **roots["L"])
    got = make_data_loader(Config(**cfg))
    want = jax_loaders(JaxConfig(**cfg))
    assert got[3] == want[3] == 19
    for g, w in zip(got[:3], want[:3]):
        assert type(g).__name__ == type(w).__name__
        assert g.threads == w.threads == 2
        assert len(g) == len(w)
        _assert_batches_close(list(g), list(w),
                              blurred=isinstance(g, PL.NativeTrainLoader))
    # P-mode labels: the port reads the indices, as from the L-mode copy;
    # the JAX native decoder reads the luma of the palette colors
    p_cfg = dict(KW, **roots["P"])
    lp = next(iter(make_data_loader(Config(**p_cfg))[0]))["src_label"]
    ll = next(iter(got[0]))["src_label"]
    jp = next(iter(jax_loaders(JaxConfig(**p_cfg))[0]))["src_label"]
    np.testing.assert_array_equal(lp, ll)
    assert not np.array_equal(jp, ll)


def _argv(roots):
    out = ["--dataset", "gtav2cityscapes", "--data-backend", "native",
           "--batch-size", "2", "--crop-size", "32", "--base-size", "32",
           "--precision", "f32", "--workers", "2", "--epochs", "1"]
    for k, v in roots.items():
        out += [f"--{k}", v]
    return out


def test_train_adapt_and_test_adapt_native(roots, tmp_path, monkeypatch):
    from s2r_tpu_torch.cli import test_adapt, train_adapt

    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    argv = _argv(roots["P"]) + ["--run-root", str(tmp_path / "run")]
    with torch_threads():
        trainer = train_adapt.main(argv)
    assert isinstance(trainer.train_loader, PL.NativeTrainLoader)
    assert isinstance(trainer.val_loader, PL.NativeEvalLoader)
    assert trainer.state.step == len(trainer.train_loader) == N_GTA // 2
    path = os.path.join(trainer.saver.experiment_dir, "scalars.jsonl")
    tags = {r["tag"]: r["value"] for r in map(json.loads, open(path))}
    for k in ("train/seg_loss", "train/adv_loss", "train/d_loss"):
        assert np.isfinite(tags[k]), k
    assert 0.0 <= tags["val/mIoU"] <= 1.0
    ckpt = trainer.saver.save_checkpoint(trainer.state, 1, trainer.best_pred,
                                         is_best=False, filename="final.ckpt")
    trainer.saver.wait()
    out = tmp_path / "test"
    with torch_threads():
        test_adapt.main(argv + ["--resume", ckpt, "--out-dir", str(out)])
    stems = sorted(f[:-len(".png")] for f in os.listdir(
        roots["P"]["test_img_root"]))
    assert sorted(os.listdir(out)) == sorted(
        [f"{s}_labelId.png" for s in stems]
        + [f"{s}_color.png" for s in stems])


def test_train_val_test_native(roots, tmp_path, monkeypatch):
    """The feature method's drivers on the native route: train one epoch
    (finite losses), val on its checkpoint reproducing the Trainer's mIoU,
    test writing one PNG pair a test frame."""
    from s2r_tpu_torch.cli import test, train, val

    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    argv = _argv(roots["P"]) + ["--run-root", str(tmp_path / "run")]
    with torch_threads():
        trainer = train.main(argv)
    assert trainer.method.name == "feature_adapt"
    assert isinstance(trainer.train_loader, PL.NativeTrainLoader)
    path = os.path.join(trainer.saver.experiment_dir, "scalars.jsonl")
    tags = {r["tag"]: r["value"] for r in map(json.loads, open(path))}
    for k in ("train/task_loss", "train/d_loss", "train/d_inv_loss"):
        assert np.isfinite(tags[k]), k
    ckpt = trainer.saver.save_checkpoint(trainer.state, 1, trainer.best_pred,
                                         is_best=False, filename="final.ckpt")
    trainer.saver.wait()
    with torch_threads():
        miou, _ = val.main(argv + ["--resume", ckpt, "--skip-sep",
                                   "--out-dir", str(tmp_path / "val")])
        test.main(argv + ["--resume", ckpt, "--out-dir",
                          str(tmp_path / "test")])
    assert abs(miou - tags["val/mIoU"]) <= 1e-6
    assert len(os.listdir(tmp_path / "test")) == 2 * N_TEST


def test_device_aug_warps_native_batches_as_jax(roots, tmp_path):
    """--device-aug on the native route: the Trainer warps the cropped,
    normalized native batch once more (the JAX Trainer applies
    augment_paired_batch whatever the backend; ROADMAP C.13)."""
    from s2r_tpu_torch.train.trainer import Trainer

    cfg = Config(**dict(KW, **roots["L"], device_aug=True, precision="f32",
                        run_root=str(tmp_path)))
    with torch_threads():
        t = Trainer(cfg, method="output_adapt", device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in next(iter(t.train_loader))
             .items()}
    assert batch["src_image"].dtype == torch.float32
    got = t._finish_batch(dict(batch), 0, 0)
    params = PA.sample_params(PA.batch_generator(cfg.seed, 0, 0), 2, 32, 32,
                              32, 32)
    want = PA.warp_paired_batch(dict(batch), params, 32)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    t.writer.close()
    key = jax.random.PRNGKey(5)
    jax_out = JA.augment_paired_batch(
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, key, 32, 32)
    port = PA.warp_paired_batch(dict(batch), _jax_params(key, 2, 32, 32, 32,
                                                         32), 32)
    for k in ("src_image", "tgt_image"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(jax_out[k]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(port["src_label"].numpy(),
                                  np.asarray(jax_out["src_label"]))


def test_profile_dir_writes_a_trace(tmp_path):
    from s2r_tpu_torch.train.trainer import Trainer

    cfg = Config(dataset="synthetic", device_aug=True, batch_size=2,
                 crop_size=32, base_size=32, workers=1, precision="f32",
                 epochs=1, run_root=str(tmp_path / "run"))
    prof = tmp_path / "prof"
    for profile_dir in (None, str(prof)):
        with torch_threads():
            t = Trainer(dataclasses.replace(cfg, profile_dir=profile_dir),
                        method="output_adapt", device="cpu")
            t.fit()
        if profile_dir is None:
            assert not prof.exists()
            assert not glob.glob(str(tmp_path / "**" / "*.pt.trace.json"),
                                 recursive=True)
    files = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
