"""JPEG frames (data/imaging.py ``decode_jpeg`` over csrc/host/jpeg.h, and
cli.infer over them) against PIL and the JAX package, on the CPU.

- Every committed fixture (s2r_tpu_torch/data/jpeg_fixtures, made by
  tools/jpeg_fixtures.py) decodes bit for bit as PIL's
  ``Image.open(f).convert("RGB")``, and PIL's decode still has the digest
  digests.json records (chip_smoke.py holds the card's build to them).
- Files PIL writes from seeded arrays over a grid: sizes from 1x1 to past
  two MCUs, odd ones among them; 4:4:4, 4:2:2, 4:2:0, 4:1:1 and gray;
  baseline and progressive; qualities 5-100; restart intervals.
- ``load_rgb`` tells JPEG from PNG by the bytes, as PIL opens by content.
- The kinds the decoder refuses (CMYK, arithmetic coding, 12-bit,
  lossless, a progressive file libjpeg would block-smooth) raise a
  ValueError naming ROADMAP A.4; a truncated or foreign file raises.
- cli.infer over odd-size .jpg frames writes labels equal to JAX
  cli.infer's (PIL route) on >= 99.9% of pixels (float near-ties, ROADMAP
  C.3), the tolerance of tests/test_torch_port_export_infer.py.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from s2r_tpu_torch.data import imaging
from s2r_tpu_torch.tools import jpeg_fixtures

FIXTURES = jpeg_fixtures.OUT
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_equals_pil(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = _pil(data)
    assert hashlib.sha256(want.tobytes()).hexdigest() == \
        DIGESTS[name]["sha256"]
    got = imaging.decode_jpeg(data, name)
    assert got.shape == tuple(DIGESTS[name]["shape"])
    np.testing.assert_array_equal(got, want)


def test_fixtures_are_the_tools():
    """The committed files are what tools/jpeg_fixtures.py makes (the big
    frame aside: its bytes are the timing's, not a case)."""
    made = jpeg_fixtures.fixtures()
    assert sorted(made) == sorted(DIGESTS)
    for name, make in made.items():
        if name == jpeg_fixtures.BIG:
            continue
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == make(), name


SIZES = [(1, 1), (2, 5), (7, 3), (9, 17), (16, 16), (23, 41), (33, 34)]


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("kind", ["444", "422", "420", "411", "gray"])
def test_grid_equals_pil(kind, progressive):
    rs = np.random.RandomState(len(kind) * 10 + int(progressive))
    sub = {"444": 0, "422": 1, "420": 2, "411": "4:1:1"}.get(kind)
    for i, (h, w) in enumerate(SIZES):
        a = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        a = (a // 2 + np.linspace(0, 127, w, dtype=np.uint8)[None, :, None])
        im = Image.fromarray(a)
        kw = dict(quality=(5, 35, 75, 100)[i % 4], progressive=progressive)
        if kind == "gray":
            im = im.convert("L")
        else:
            kw["subsampling"] = sub
        if i % 3 == 2:
            kw["restart_marker_blocks"] = 1 + i % 2
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        data = buf.getvalue()
        np.testing.assert_array_equal(imaging.decode_jpeg(data), _pil(data),
                                      err_msg=str((h, w, kw)))


def test_load_rgb_by_content(tmp_path):
    """A JPEG named .png and a PNG named .jpg: PIL opens both by their
    bytes, and so does load_rgb."""
    rs = np.random.RandomState(3)
    a = rs.randint(0, 256, (19, 23, 3)).astype(np.uint8)
    jpg, png = tmp_path / "a.png", tmp_path / "b.jpg"
    Image.fromarray(a).save(str(jpg), "JPEG", quality=80)
    Image.fromarray(a).save(str(png), "PNG")
    for p in (jpg, png):
        np.testing.assert_array_equal(
            imaging.load_rgb(str(p)),
            np.asarray(Image.open(str(p)).convert("RGB")))


def _base(**kw) -> bytes:
    buf = io.BytesIO()
    rs = np.random.RandomState(4)
    Image.fromarray(rs.randint(0, 256, (17, 21, 3)).astype(np.uint8)).save(
        buf, "JPEG", **kw)
    return buf.getvalue()


def _sof(data: bytes, code: int, precision: int = 8) -> bytes:
    d = bytearray(data)
    i = d.index(b"\xff\xc0")
    d[i + 1], d[i + 4] = code, precision
    return bytes(d)


def _unsmoothed_progressive() -> bytes:
    """A progressive file cut after its DC scans and first AC scans (the
    refinement passes dropped): libjpeg would block-smooth it."""
    d = _base(quality=80, progressive=True)
    scans = [i for i in range(len(d) - 1) if d[i:i + 2] == b"\xff\xda"]
    return d[:scans[3]] + b"\xff\xd9"


@pytest.mark.parametrize("make", [
    lambda: _base_cmyk(),
    lambda: _sof(_base(quality=80), 0xC9),   # arithmetic coding
    lambda: _sof(_base(quality=80), 0xC1, 12),  # 12-bit samples
    lambda: _sof(_base(quality=80), 0xC3),   # lossless
    _unsmoothed_progressive,
], ids=["cmyk", "arithmetic", "12bit", "lossless", "smoothing"])
def test_refused_kinds_name_roadmap(make):
    with pytest.raises(ValueError, match="ROADMAP A.4"):
        imaging.decode_jpeg(make())


def _base_cmyk() -> bytes:
    buf = io.BytesIO()
    Image.new("CMYK", (9, 7), (10, 20, 30, 40)).save(buf, "JPEG")
    return buf.getvalue()


def test_broken_files_raise():
    data = _base(quality=80)
    for bad in (data[:len(data) // 2], b"\xff\xd8\xff\xe0\x00",
                b"GIF89a" + data, data[:2] + b"\xff\xd9"):
        with pytest.raises(ValueError):
            imaging.decode_jpeg(bad)


# ------------------------------------------------------------ cli.infer ---

HW, BATCH = 64, 2
FRAMES = [(50, 70), (64, 64), (81, 47)]


def test_infer_jpeg_frames_match_jax(tmp_path, monkeypatch):
    """A servable of seeded full-width weights at 64x64 batch 2, exported
    by both packages; three odd-size .jpg frames (4:2:0, progressive,
    gray), the tail batch padded."""
    from s2r_tpu.cli import infer as jax_infer
    from s2r_tpu.io.serving import export_servable as jax_export_servable
    from s2r_tpu_torch import config as PC
    from s2r_tpu_torch.cli import export, infer
    from s2r_tpu_torch.io.checkpoint import save_checkpoint
    from s2r_tpu_torch.io.convert import from_jax_variables
    from s2r_tpu_torch.train.setup import build_method

    from _torch_port_common import jax_deeplab, torch_threads

    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    model, params, stats = jax_deeplab(HW)
    st = build_method(PC.Config(precision="f32"), 1, method="output_adapt",
                      device="cpu").init_state()
    st.G.load_state_dict(from_jax_variables(params, stats), strict=True)
    ckpt, shlo = str(tmp_path / "m.ckpt"), str(tmp_path / "m.shlo")
    save_checkpoint(ckpt, st, 1, 0.5)
    jax_export_servable(model, params, stats, (BATCH, HW, HW, 3), shlo,
                        output="logits", input="rgb8")
    servable = str(tmp_path / "m.s2rt")
    with torch_threads():
        export.main(["--dataset", "synthetic", "--precision", "f32",
                     "--crop-size", str(HW), "--base-size", str(HW),
                     "--batch-size", str(BATCH), "--workers", "1",
                     "--resume", ckpt, "--out", servable, "--format",
                     "servable", "--serve-shape", str(BATCH), str(HW),
                     str(HW), "--serve-input", "rgb8"])
    frames = tmp_path / "frames"
    os.makedirs(frames)
    rs = np.random.RandomState(5)
    for i, (h, w) in enumerate(FRAMES):
        im = Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        if i == 2:
            im = im.convert("L")
        im.save(str(frames / f"f{i}.jpg"), "JPEG", quality=85,
                progressive=i == 1)
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    with torch_threads():
        res = infer.main(["--servable", servable, "--images", str(frames),
                          "--out-dir", out_p, "--workers", "2"])
    assert res["images"] == len(FRAMES)
    assert jax_infer.main(["--servable", shlo, "--images", str(frames),
                           "--out-dir", out_j, "--host-backend", "pil",
                           "--workers", "2"]) == len(FRAMES)
    names = sorted(os.listdir(out_p))
    assert names == sorted(os.listdir(out_j)) and len(names) == 2 * len(
        FRAMES)
    same = total = 0
    for name in [n for n in names if n.endswith("_labelId.png")]:
        a = imaging.load_raw(os.path.join(out_p, name))
        b = np.asarray(Image.open(os.path.join(out_j, name)))
        same += int((a == b).sum())
        total += a.size
    assert same / total >= 0.999, same / total
