"""The port's host imaging library (s2r_tpu_torch/data/imaging.py over
csrc/host/imaging.cpp) against PIL, bit for bit, on the CPU.

This environment has PIL; the port never imports it.  Every comparison is
exact (``assert_array_equal``):
- decode of PIL-written PNGs of every color type the datasets use (RGB, L,
  RGBA, LA, P at 8 bits and P at 1/2/4 bits, mode "1"), with and without
  tRNS, as ``np.asarray(Image.open(p))`` and ``.convert("RGB")`` give them;
- decode of hand-written PNGs with each filter type (None, Sub, Up,
  Average, Paeth, and all five cycled row by row) at 1x1, 1x7 and 37x53,
  gray and palette at 1/2/4/8 bits, RGB, gray+alpha and RGBA;
- 16-bit gray and 16-bit gray+alpha as raw samples decode as PIL decodes
  them, a 16-bit palette file raises naming the file and ROADMAP A.4, and
  an Adam7 file decodes as PIL decodes it (test_torch_port_native_decode.py
  holds the rest of Adam7 and 16 bits);
- BILINEAR against ``Image.resize``: up and down, odd sizes, every short
  edge RandomScaleCrop draws at base 32, 48 and 64 from 40x60 and 64x48
  frames, and ``box=`` windows formed as hostcrop forms them;
- NEAREST, 512 -> 640 among the sizes;
- GaussianBlur at radii 0, 1e-3, 0.25, 0.5, 0.999 and 20 radii drawn from
  ``random.Random``, on RGB and on a padded crop;
- the golden digest chip_smoke.py checks on the card (which has no PIL):
  the port's outputs and PIL's on the same seeded calls hash to the same
  constant.
"""

import io
import os
import random
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFilter

from s2r_tpu.data import transforms as JT
from s2r_tpu_torch.data import imaging
from s2r_tpu_torch.data import transforms as PT
from s2r_tpu_torch.utils.png import filter_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

GOLDEN = ("f1fe458d3373a00780bc5f622587d69c"
          "dbd9121e95e6db07dc485613188b8336")


def _pil_png(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "PNG", **kw)
    return b.getvalue()


def _assert_decodes_like_pil(data: bytes):
    im = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(imaging.decode_png(data, False),
                                  np.asarray(im, np.uint8))
    np.testing.assert_array_equal(imaging.decode_png(data, True),
                                  np.asarray(im.convert("RGB")))


def _rgb(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("trns", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "P1", "P2",
                                  "P4", "1"])
def test_decode_pil_written(mode, trns):
    base = Image.fromarray(_rgb(37, 53, len(mode)))
    kw = {}
    if mode.startswith("P"):
        bits = int(mode[1:] or 8)
        im = base.quantize(colors=2 ** bits)
        if bits < 8:
            kw["bits"] = bits
        if trns:
            kw["transparency"] = bytes([0, 128, 255][:2 ** bits])
    else:
        im = base.convert(mode)
        if trns and mode in ("RGB", "L", "1"):
            kw["transparency"] = {"RGB": (1, 2, 3), "L": 7, "1": 1}[mode]
    data = _pil_png(im, **kw)
    assert (b"tRNS" in data) == (trns and mode not in ("RGBA", "LA"))
    _assert_decodes_like_pil(data)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # (x0, y0, dx, dy)


def _scanlines(samples, depth, filters):
    """The filtered scanlines of `samples`, packed MSB first."""
    h, w = samples.shape[:2]
    ch = 1 if samples.ndim == 2 else samples.shape[2]
    v = samples.reshape(h, w * ch).astype(np.uint16)
    if depth == 16:
        rows = np.stack([v >> 8, v & 255], -1).reshape(h, -1).astype(np.uint8)
    elif depth == 8:
        rows = v.astype(np.uint8)
    else:
        bits = (v[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    return filter_rows(rows, max(1, ch * depth // 8), filters).tobytes()


def _hand_png(samples, color, depth, filters, palette=None, interlace=0):
    """A PNG of `samples` ([H, W] or [H, W, C], values < 2**depth), the
    scanlines packed MSB first and filtered with `filters` in turn; with
    `interlace`, the seven Adam7 passes (each filtered on its own, empty
    ones left out)."""
    h, w = samples.shape[:2]
    if interlace:
        raw = b"".join(_scanlines(samples[y0::dy, x0::dx], depth, filters)
                       for x0, y0, dx, dy in ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _scanlines(samples, depth, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return (out + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


FILTER_SETS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (3, 1), (3, 2), (3, 4), (3, 8),
         (2, 8), (4, 8), (6, 8)]


@pytest.mark.parametrize("hw", [(1, 1), (1, 7), (37, 53)])
@pytest.mark.parametrize("filters", FILTER_SETS)
def test_decode_hand_written(hw, filters):
    rs = np.random.RandomState(hw[0] * 100 + hw[1] + len(filters))
    for color, depth in KINDS:
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
        shape = hw if ch == 1 else hw + (ch,)
        samples = rs.randint(0, 2 ** depth, shape)
        palette = None
        if color == 3:
            palette = rs.randint(0, 256, (2 ** depth, 3)).astype(np.uint8)
        data = _hand_png(samples, color, depth, filters, palette)
        _assert_decodes_like_pil(data)
        if depth == 8 or color == 3:  # the samples come back as written
            np.testing.assert_array_equal(imaging.decode_png(data, False),
                                          samples)


def test_unsupported_pngs_raise(tmp_path):
    """16-bit gray (Pillow's "I;16") and 16-bit gray+alpha as raw samples
    (Pillow opens it as RGBA), which raised before, decode as PIL decodes
    them; a depth no PNG of its color type may have (a 16-bit palette)
    still raises, naming the file and ROADMAP A.4; an Adam7 file decodes
    as PIL decodes it (tests/test_torch_port_native_decode.py covers every
    kind, tests/test_torch_port_data_rest.py the 16-bit gray cases)."""
    rs = np.random.RandomState(0)
    deep = _hand_png(rs.randint(0, 65536, (5, 6)), 0, 16, (0,))
    cases = {"deep.png": deep,
             "deep_la.png": _hand_png(rs.randint(0, 65536, (5, 6, 2)), 4,
                                      16, (0,))}
    for name, data in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        im = Image.open(str(path))
        np.testing.assert_array_equal(imaging.load_raw(str(path)),
                                      np.asarray(im, np.uint8))
        np.testing.assert_array_equal(imaging.load_rgb(str(path)),
                                      np.asarray(im.convert("RGB")))
    bad = bytearray(deep)  # IHDR's color type 0 -> 3, its CRC redone
    bad[25] = 3
    bad[29:33] = struct.pack(">I", zlib.crc32(bytes(bad[12:29])) & 0xFFFFFFFF)
    path = tmp_path / "deep_palette.png"
    path.write_bytes(bytes(bad))
    for load in (imaging.load_rgb, imaging.load_raw):
        with pytest.raises(ValueError, match="deep_palette.png.*A.4"):
            load(str(path))
    path = tmp_path / "adam7.png"
    path.write_bytes(_hand_png(rs.randint(0, 256, (5, 6)), 0, 8, (0,),
                               interlace=1))
    im = Image.open(str(path))
    assert im.info.get("interlace") == 1
    np.testing.assert_array_equal(imaging.load_raw(str(path)),
                                  np.asarray(im))
    np.testing.assert_array_equal(imaging.load_rgb(str(path)),
                                  np.asarray(im.convert("RGB")))


def _pil_resize(img, size, box=None, resample=Image.BILINEAR):
    return np.asarray(Image.fromarray(img).resize(size, resample, box=box))


@pytest.mark.parametrize("src", [(37, 53), (53, 37), (1, 9), (97, 131)])
def test_bilinear_sizes(src):
    img = _rgb(*src, seed=src[0])
    for size in [(1, 1), (3, 2), (26, 18), (53, 37), (106, 74), (211, 7),
                 (src[1], src[0]), (src[1] + 1, src[0] - 1 or 1)]:
        for a in (img, np.ascontiguousarray(img[..., 1])):
            np.testing.assert_array_equal(imaging.resize_bilinear(a, size),
                                          _pil_resize(a, size))


@pytest.mark.parametrize("base", [32, 48, 64])
@pytest.mark.parametrize("hw", [(40, 60), (64, 48)])
def test_bilinear_scalecrop_short_edges(base, hw):
    img = _rgb(*hw, seed=base)
    h, w = hw
    for short in range(base // 2, 2 * base + 1):
        size = ((short, int(1.0 * h * short / w)) if h > w
                else (int(1.0 * w * short / h), short))
        np.testing.assert_array_equal(imaging.resize_bilinear(img, size),
                                      _pil_resize(img, size))


def test_bilinear_hostcrop_boxes():
    """box= windows as hostcrop.scalecrop_from_frame forms them, flipped
    and not, with crops running into the padding."""
    from s2r_tpu_torch.data import hostcrop

    rr = random.Random(5)
    img = _rgb(48, 64, seed=9)
    for _ in range(60):
        flip, ow, oh, x1, y1 = hostcrop.draw_params(rr, 40, 36, 36, 64, 48)
        iw, ih = min(36, ow - x1), min(36, oh - y1)
        lo_x = (ow - x1 - iw) if flip else x1
        box = (lo_x * 64 / ow, y1 * 48 / oh, (lo_x + iw) * 64 / ow,
               (y1 + ih) * 48 / oh)
        np.testing.assert_array_equal(
            imaging.resize_bilinear(img, (iw, ih), box=box),
            _pil_resize(img, (iw, ih), box=box))


@pytest.mark.parametrize("src,size", [((512, 512), (640, 640)),
                                      ((37, 53), (17, 90)),
                                      ((1052, 1914), (560, 305)),
                                      ((64, 48), (48, 64))])
def test_nearest(src, size):
    rs = np.random.RandomState(1)
    for shape in (src, src + (3,)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            imaging.resize_nearest(img, size),
            _pil_resize(img, size, resample=Image.NEAREST))


RADII = [0, 1e-3, 0.25, 0.5, 0.999] + [
    random.Random(11).random() for _ in range(20)]


@pytest.mark.parametrize("radius", RADII)
def test_gaussian_blur(radius):
    img = _rgb(41, 57, seed=3)
    crop = np.zeros((48, 48, 3), np.uint8)  # a crop padded right and bottom
    crop[:30, :41] = img[:30, :41]
    for a in (img, crop, np.ascontiguousarray(img[..., 2])):
        want = np.asarray(Image.fromarray(a).filter(
            ImageFilter.GaussianBlur(radius)))
        np.testing.assert_array_equal(imaging.gaussian_blur(a, radius), want)


def test_golden_digest_equals_pil():
    """chip_smoke.py phase 7 holds the card's outputs to this constant."""

    def pil_transform(sample, rng):
        t = JT.Compose([JT.RandomHorizontalFlip(),
                        JT.RandomScaleCrop(chip_smoke.DIGEST_BASE,
                                           chip_smoke.DIGEST_CROP, fill=255),
                        JT.RandomGaussianBlur()])
        out = t({k: Image.fromarray(v) for k, v in sample.items()}, rng)
        return {k: np.asarray(v) for k, v in out.items()}

    pil = chip_smoke.imaging_digest(
        _pil_resize,
        lambda a, r: np.asarray(Image.fromarray(a).filter(
            ImageFilter.GaussianBlur(r))),
        pil_transform)
    port = chip_smoke.imaging_digest(
        imaging.resize_bilinear, imaging.gaussian_blur,
        PT.train_transforms(chip_smoke.DIGEST_BASE, chip_smoke.DIGEST_CROP))
    assert pil == port == GOLDEN == chip_smoke.IMAGING_DIGEST


def test_failed_build_raises(monkeypatch):
    """No fallback: a host library that does not build raises."""
    from s2r_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "GXX_FLAGS",
                        build.GXX_FLAGS + ("-fno-such-flag-exists",))
    assert not build._target("imaging").exists()
    with pytest.raises(RuntimeError, match="build failed"):
        build.build_all(["imaging"])
    assert not build._target("imaging").exists()
