"""The port's servable and its two drivers (s2r_tpu_torch/io/serving.py
export_servable / load_servable / Servable, cli/export.py --format
servable, cli/infer.py) against the JAX package's (s2r_tpu/io/serving.py,
cli/infer.py), on the CPU at 64x64 with full-width weights.

- cli.export --format servable of a seeded checkpoint, loaded, gives
  logits within 1e-4 * max(1, max|ref|) of s2r_tpu's export_servable ->
  load_servable on the same frames (the tolerance of
  test_torch_port_serving.py).
- The meta round-trips, holds every key of the JAX meta, and records the
  checkpoint's epoch and best_pred; a bad magic and a JAX .shlo raise; a
  shape other than the exported one raises, and with --serve-batch-poly
  only N may differ; an unknown platform and --serve-split-concat raise.
- cli.infer over odd-size PNG frames with a padded tail batch writes
  labelId PNGs equal to JAX cli.infer's on >= 99.9% of pixels (labels
  differ only at float near-ties, ROADMAP C.3) and byte-equal to what
  _save_prediction writes for the port's in-process make_serving_fn on the
  same decoded, resized frames; JPEG frames raise (ROADMAP A.4).
- Marked slow, as tests/test_serving.py's is: the port serves
  run/synthetic/conv-reval/model_best.ckpt (a JAX checkpoint) with the
  JAX package's mIoU and labels.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from s2r_tpu.io.serving import export_servable as jax_export_servable
from s2r_tpu.io.serving import load_servable as jax_load_servable
from s2r_tpu_torch import config as PC
from s2r_tpu_torch.io.checkpoint import save_checkpoint
from s2r_tpu_torch.io.convert import from_jax_variables
from s2r_tpu_torch.io.serving import (load_servable, make_serving_fn,
                                      read_servable)
from s2r_tpu_torch.train.setup import build_method

from _torch_port_common import jax_deeplab, torch_threads

HW = 64
BATCH = 2
ARGV = ["--dataset", "synthetic", "--precision", "f32", "--crop-size",
        str(HW), "--base-size", str(HW), "--batch-size", str(BATCH),
        "--workers", "1"]


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """(JAX model, params, stats, a port checkpoint of the same weights
    at epoch 5, best_pred 0.75, a JAX .shlo of them: logits from rgb8 at
    [2, 64, 64, 3], exported as s2r_tpu's cli.export does, and its
    meta)."""
    root = tmp_path_factory.mktemp("seeded")
    model, params, stats = jax_deeplab(HW)
    st = build_method(PC.Config(precision="f32"), 1, method="output_adapt",
                      device="cpu").init_state()
    st.G.load_state_dict(from_jax_variables(params, stats), strict=True)
    ckpt = str(root / "seeded.ckpt")
    save_checkpoint(ckpt, st, 5, 0.75)
    shlo = str(root / "jax.shlo")
    info = jax_export_servable(model, params, stats, (BATCH, HW, HW, 3),
                               shlo, output="logits", input="rgb8",
                               meta={"epoch": 5, "best_pred": 0.75})
    return model, params, stats, ckpt, shlo, info


def _export(ckpt, out, *flags):
    from s2r_tpu_torch.cli import export

    with torch_threads():
        return export.main(ARGV + ["--resume", ckpt, "--out", out,
                                   "--format", "servable",
                                   "--serve-shape", str(BATCH), str(HW),
                                   str(HW)] + list(flags))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("S2R_PLATFORM", "cpu")


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n, HW, HW, 3)).astype(np.uint8)


def test_servable_logits_match_jax(seeded, tmp_path):
    _, _, _, ckpt, shlo, _ = seeded
    out = str(tmp_path / "m.s2rt")
    _export(ckpt, out, "--serve-output", "logits", "--serve-input", "rgb8")
    serve = load_servable(out, device="cpu")
    frames = _frames(BATCH)
    with torch_threads():
        got = serve(frames).numpy()
    ref = np.asarray(jax_load_servable(shlo)(frames))
    assert got.shape == ref.shape == (BATCH, HW, HW, 19)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol


@pytest.mark.parametrize("flags", [
    ["--serve-input", "rgb8"],
    ["--serve-argmax", "decoder", "--serve-label-dtype", "uint8",
     "--serve-pad-batch", "4"],
    ["--serve-output", "probs", "--serve-batch-poly", "--serve-platforms",
     "cuda", "cpu"],
    ["--serve-quant", "decoder-int8", "--calib-batches", "2"]])
def test_servable_meta_round_trips(seeded, tmp_path, flags):
    _, params, stats, ckpt, _, jax_info = seeded
    out = str(tmp_path / "m.s2rt")
    info = _export(ckpt, out, *flags)
    meta, weights = read_servable(out)
    assert meta == info
    assert set(jax_info) | {"precision"} == set(meta)
    assert meta["format"] == "s2r_tpu_torch.servable"
    assert (meta["epoch"], meta["best_pred"]) == (5, 0.75)
    assert meta["input_shape"] == [BATCH, HW, HW, 3]
    assert meta["precision"] == "f32"
    assert meta["platforms"] == (["cuda", "cpu"] if "cuda" in flags
                                 else ["cpu"])
    if "decoder-int8" in flags:
        assert meta["quant"] == "decoder_int8"
        assert set(meta["quant_scales"]) == {"a0", "a1"}
    want = from_jax_variables(params, stats)
    assert all(torch.equal(weights[k], want[k]) for k in want)


def test_bad_magic_and_jax_shlo_raise(seeded, tmp_path):
    shlo = seeded[4]
    with pytest.raises(ValueError, match="StableHLO"):
        load_servable(shlo, device="cpu")
    bad = str(tmp_path / "bad.s2rt")
    with open(bad, "wb") as f:
        f.write(b"NOTASERV" + b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        load_servable(bad, device="cpu")


def test_input_shape_is_checked(seeded, tmp_path):
    ckpt = seeded[3]
    fixed, poly = str(tmp_path / "fixed.s2rt"), str(tmp_path / "poly.s2rt")
    _export(ckpt, fixed, "--serve-input", "rgb8")
    _export(ckpt, poly, "--serve-input", "rgb8", "--serve-batch-poly")
    serve = load_servable(fixed, device="cpu")
    with pytest.raises(ValueError, match="input shape"):
        serve(_frames(3))
    with pytest.raises(ValueError, match="input dtype"):
        serve(_frames(BATCH).astype(np.float32))
    serve = load_servable(poly, device="cpu")
    with torch_threads():
        for n in (1, 3):
            assert tuple(serve(_frames(n)).shape) == (n, HW, HW)
    with pytest.raises(ValueError, match="input shape"):
        serve(_frames(1)[:, :32])


def test_unported_export_flags_raise(seeded, tmp_path):
    ckpt = seeded[3]
    with pytest.raises(ValueError, match="platforms"):
        _export(ckpt, str(tmp_path / "a"), "--serve-platforms", "tpu")
    with pytest.raises(NotImplementedError, match="A.5"):
        _export(ckpt, str(tmp_path / "b"), "--serve-split-concat")


SIZES = [(50, 70), (64, 64), (81, 47), (37, 90), (64, 65)]


def test_infer_matches_jax_and_in_process(seeded, tmp_path):
    """5 odd-size frames at batch 2: the tail batch is padded."""
    from s2r_tpu.cli import infer as jax_infer
    from s2r_tpu_torch.cli import infer
    from s2r_tpu_torch.cli._eval_common import _save_prediction
    from s2r_tpu_torch.data.imaging import load_raw

    _, _, _, ckpt, shlo, _ = seeded
    frames = tmp_path / "frames"
    os.makedirs(frames / "sub")
    rs = np.random.RandomState(2)
    for i, (h, w) in enumerate(SIZES):
        d = frames / "sub" if i == 4 else frames
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(str(d / f"f{i}.png"))
    servable = str(tmp_path / "m.s2rt")
    _export(ckpt, servable, "--serve-input", "rgb8")
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    with torch_threads():
        res = infer.main(["--servable", servable, "--images", str(frames),
                          "--out-dir", out_p, "--workers", "2"],
                         keep_predictions=True)
    assert res["images"] == len(SIZES)
    assert jax_infer.main(["--servable", shlo, "--images", str(frames),
                           "--out-dir", out_j, "--host-backend", "pil",
                           "--workers", "2"]) == len(SIZES)
    names = sorted(os.listdir(out_p))
    assert names == sorted(os.listdir(out_j)) and len(names) == 2 * len(SIZES)
    same = total = 0
    for name in [n for n in names if n.endswith("_labelId.png")]:
        a = load_raw(os.path.join(out_p, name))
        b = np.asarray(Image.open(os.path.join(out_j, name)))
        same += int((a == b).sum())
        total += a.size
    assert same / total >= 0.999, same / total

    # in process: the same servable's model on the same decoded frames
    serve = load_servable(servable, device="cpu")
    fn = make_serving_fn(serve.model, input="rgb8")
    out_e = str(tmp_path / "expected")
    for path, pred in res["predictions"].items():
        x = infer.decode_frame(path, HW, HW, "rgb8")[None]
        with torch_threads():
            want = fn(np.concatenate([x] * BATCH))[0].numpy()
        np.testing.assert_array_equal(pred, want)
        _save_prediction(want, os.path.basename(path), out_e, "cityscapes")
    for name in names:
        with open(os.path.join(out_p, name), "rb") as f, \
                open(os.path.join(out_e, name), "rb") as g:
            assert f.read() == g.read(), name


def test_infer_refuses_jpeg(seeded, tmp_path):
    from s2r_tpu_torch.cli import infer

    frames = tmp_path / "frames"
    os.makedirs(frames)
    Image.fromarray(_frames(1)[0]).save(str(frames / "a.jpg"))
    with pytest.raises(NotImplementedError, match="A.4"):
        infer.main(["--servable", str(tmp_path / "none"), "--images",
                    str(frames)])


@pytest.mark.slow
def test_port_serves_trained_jax_checkpoint(tmp_path):
    """The committed convergence checkpoint (a JAX .ckpt, held-out mIoU
    ~0.81) through cli.export --format servable and the port's servable
    over the synthetic val set: mIoU within 5e-3 of the JAX package's
    eval, labels equal to JAX's servable on >= 99.9% of pixels."""
    from s2r_tpu.config import Config as JaxConfig
    from s2r_tpu.data.loader import make_data_loader
    from s2r_tpu.eval.metrics import Evaluator
    from s2r_tpu.io.checkpoint import load_checkpoint
    from s2r_tpu.train.setup import build_method as jax_build

    ckpt = "run/synthetic/conv-reval/model_best.ckpt"
    cfg = JaxConfig(dataset="synthetic", crop_size=128, base_size=128,
                    batch_size=4)
    m = jax_build(cfg, iters_per_epoch=1, method="output_adapt")
    state = load_checkpoint(ckpt, m.init_state(jax.random.PRNGKey(0)))[
        "state"]
    params, bstats = m.eval_variables(state)
    shlo = str(tmp_path / "trained.shlo")
    eval_deeplab = (m.deeplab.clone(logits_dtype=None)
                    if m.deeplab.logits_dtype is not None else m.deeplab)
    jax_export_servable(eval_deeplab, params, bstats, (4, 128, 128, 3), shlo)
    jserve = jax_load_servable(shlo)

    out = str(tmp_path / "trained.s2rt")
    from s2r_tpu_torch.cli import export

    export.main(["--dataset", "synthetic", "--crop-size", "128",
                 "--base-size", "128", "--batch-size", "4", "--resume",
                 ckpt, "--out", out, "--format", "servable",
                 "--serve-shape", "4", "128", "128"])
    serve = load_servable(out, device="cpu")
    _, val_loader, _, nclass = make_data_loader(cfg)
    ev_jax, ev_port = Evaluator(nclass), Evaluator(nclass)
    agree = total = 0
    for batch in val_loader:
        want = np.asarray(jserve(batch["image"]))
        got = serve(batch["image"]).numpy()
        ev_jax.add_batch(batch["label"], want)
        ev_port.add_batch(batch["label"], got)
        agree += int((got == want).sum())
        total += got.size
    miou_jax, _ = ev_jax.Mean_Intersection_over_Union()
    miou_port, _ = ev_port.Mean_Intersection_over_Union()
    assert miou_jax > 0.75, miou_jax
    assert abs(miou_port - miou_jax) < 5e-3, (miou_port, miou_jax)
    assert agree / total >= 0.999, agree / total
