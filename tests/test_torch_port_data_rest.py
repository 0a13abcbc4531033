"""The rest of the data path (ROADMAP A.4) against PIL and the JAX
package's libpng decoder, bit for bit, on the CPU.

- ``imaging.rotate`` equals ``Image.rotate`` with NEAREST and BILINEAR on
  L and RGB images of odd sizes, at seeded angles and at Pillow's
  shortcuts (0, 180, 90 and 270 on a square, angles past 360 and below
  0, a rotation so small the matrix loses its shear).
- ``RandomRotate`` equals s2r_tpu.data.transforms.RandomRotate on PIL
  images from the same ``random.Random``: one angle a sample, the images
  BILINEAR, the labels NEAREST with 0 in the uncovered corners (ROADMAP
  C.17).
- 16-bit gray on the PIL route: ``load_raw`` is np.asarray(Image.open(p),
  np.uint8), the low byte; ``load_rgb`` is convert("RGB"), min(v, 255);
  16-bit gray+alpha raw is Pillow's RGBA; interlaced or not.
- The native route's one channel of 8-bit RGB and RGBA files with a gAMA
  (45455, 100000, 220000, 30000), an sRGB, or a cHRM and gAMA chunk
  equals s2r_tpu.native.decode_png(p, 1) (libpng's rgb_to_gray in linear
  light); a gAMA after IDAT is ignored, as libpng ignores it; a 16-bit
  RGB file whose gamma would take libpng's 16-bit tables raises.
- chip_smoke.py's REST_DIGEST is the hash of PIL's and libpng's results
  on rest_digest's seeded calls, and of the port's.
"""

import io
import os
import random
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from s2r_tpu import native as JN
from s2r_tpu.data import transforms as JT
from s2r_tpu_torch.data import imaging
from s2r_tpu_torch.data import native as PN
from s2r_tpu_torch.data import transforms as PT
from test_torch_port_imaging import _chunk, _hand_png

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ANGLES = [0.0, 180.0, 90.0, 270.0, -90.0, 360.0, 725.5, 1e-14, 45.0]


@pytest.mark.parametrize("hw", [(1, 1), (7, 7), (19, 33), (64, 48)])
def test_rotate_equals_pil(hw):
    rs = np.random.RandomState(hw[0] * 7 + hw[1])
    rgb = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    lab = rs.randint(0, 19, hw).astype(np.uint8)
    for angle in ANGLES + list(rs.uniform(-30, 30, 8)):
        for img in (rgb, lab):
            for bilinear in (False, True):
                want = np.asarray(Image.fromarray(img).rotate(
                    angle, Image.BILINEAR if bilinear else Image.NEAREST))
                np.testing.assert_array_equal(
                    imaging.rotate(img, angle, bilinear), want,
                    err_msg=f"{angle} {img.shape} {bilinear}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rotate_equals_jax(seed):
    rs = np.random.RandomState(seed)
    h, w = 21 + seed * 10, 37 - seed * 5
    image = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    label = rs.randint(0, 19, (h, w)).astype(np.uint8)
    label[:2] = 255
    port, jax = PT.RandomRotate(15 + 10 * seed), JT.RandomRotate(
        15 + 10 * seed)
    r1, r2 = random.Random(seed), random.Random(seed)
    for _ in range(4):
        got = port({"image": image, "label": label}, r1)
        want = jax({"image": Image.fromarray(image),
                    "label": Image.fromarray(label)}, r2)
        for k in ("image", "label"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
        assert (got["label"] == 0).any()  # the corners: 0, not 255
    assert r1.random() == r2.random()  # one draw a sample on both


@pytest.mark.parametrize("interlace", [0, 1])
def test_16_bit_gray_equals_pil(interlace):
    rs = np.random.RandomState(interlace)
    for hw in [(1, 1), (5, 9), (17, 13)]:
        v = rs.randint(0, 65536, hw)
        v.flat[:4] = [0, 255, 256, 5000][:v.size]
        for samples, color in ((v, 0),
                               (np.stack([v, v[::-1, ::-1]], -1), 4)):
            data = _hand_png(samples, color, 16, (0, 1, 2, 3, 4),
                             interlace=interlace)
            im = Image.open(io.BytesIO(data))
            np.testing.assert_array_equal(imaging.decode_png(data, False),
                                          np.asarray(im, np.uint8))
            np.testing.assert_array_equal(imaging.decode_png(data, True),
                                          np.asarray(im.convert("RGB")))


def _with_chunks(data: bytes, chunks, after: bytes = b"IHDR") -> bytes:
    """`data` with `chunks` ((kind, body), ...) after the first `after`."""
    i = data.index(after) - 4
    n = struct.unpack(">I", data[i:i + 4])[0]
    j = i + 12 + n
    return data[:j] + b"".join(_chunk(k, b) for k, b in chunks) + data[j:]


def _gama(g: int):
    return (b"gAMA", struct.pack(">I", g))


CHRM = (b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000,
                             60000, 15000, 6000))
CHUNKS = {"gama45455": [_gama(45455)], "gama100000": [_gama(100000)],
          "gama220000": [_gama(220000)], "gama30000": [_gama(30000)],
          "srgb": [(b"sRGB", b"\x00")], "chrm_gama": [CHRM, _gama(45455)]}


@pytest.mark.parametrize("name", sorted(CHUNKS))
def test_gamma_gray_equals_libpng(name):
    rs = np.random.RandomState(len(name))
    for color in (2, 6):
        for interlace in (0, 1):
            ch = 3 if color == 2 else 4
            samples = rs.randint(0, 256, (9, 11, ch))
            samples[0, :3, :3] = [[0, 0, 0], [255, 255, 255], [7, 7, 7]]
            data = _with_chunks(_hand_png(samples, color, 8, (0, 4),
                                          interlace=interlace), CHUNKS[name])
            want = JN.decode_png(data, 1)
            np.testing.assert_array_equal(PN.decode_png(data, 1), want)
            np.testing.assert_array_equal(PN.decode_png(data, 3),
                                          JN.decode_png(data, 3))
            if name == "gama100000":  # within 5% of 1: no correction
                plain = _hand_png(samples, color, 8, (0, 4),
                                  interlace=interlace)
                np.testing.assert_array_equal(want, JN.decode_png(plain, 1))
            elif name != "chrm_gama":
                assert not np.array_equal(want, JN.decode_png(
                    _hand_png(samples, color, 8, (0, 4),
                              interlace=interlace), 1))


def test_late_gamma_is_ignored():
    """A gAMA after IDAT is out of place: libpng ignores it, and so does
    the port."""
    rs = np.random.RandomState(9)
    samples = rs.randint(0, 256, (6, 7, 3))
    data = _with_chunks(_hand_png(samples, 2, 8, (0,)), [_gama(45455)],
                        after=b"IDAT")
    np.testing.assert_array_equal(PN.decode_png(data, 1),
                                  JN.decode_png(data, 1))
    np.testing.assert_array_equal(
        PN.decode_png(data, 1),
        PN.decode_png(_hand_png(samples, 2, 8, (0,)), 1))


def test_16_bit_gamma_gray_refused():
    """A 16-bit RGB file with a gamma would take libpng's 16-bit tables,
    which the port's reader leaves out (ROADMAP A.4): it raises where it
    would differ, and decodes as libpng at gamma 1."""
    rs = np.random.RandomState(10)
    samples = rs.randint(0, 65536, (4, 5, 3))
    data = _with_chunks(_hand_png(samples, 2, 16, (0,)), [_gama(45455)])
    with pytest.raises(ValueError, match="A.4"):
        PN.decode_png(data, 1)
    data = _with_chunks(_hand_png(samples, 2, 16, (0,)), [_gama(100000)])
    np.testing.assert_array_equal(PN.decode_png(data, 1),
                                  JN.decode_png(data, 1))


def test_rest_digest_is_pils_and_libpngs():
    """chip_smoke.py phase 15d holds the card's build to REST_DIGEST: the
    hash of PIL's rotate and 16-bit decodes and libpng's gamma gray on the
    same seeded calls, and of the port's."""
    jax_rotate = JT.RandomRotate(chip_smoke.REST_ROTATE)

    def pil_rotate(sample, rng):
        return {k: np.asarray(v) for k, v in jax_rotate(
            {k: Image.fromarray(v) for k, v in sample.items()}, rng).items()}

    def pil16(data, rgb):
        im = Image.open(io.BytesIO(data))
        return np.asarray(im.convert("RGB")) if rgb else np.asarray(
            im, np.uint8)

    theirs = chip_smoke.rest_digest(pil_rotate, pil16,
                                    lambda d: JN.decode_png(d, 1))
    ours = chip_smoke.rest_digest(PT.RandomRotate(chip_smoke.REST_ROTATE),
                                  imaging.decode_png,
                                  lambda d: PN.decode_png(d, 1))
    assert theirs == ours == chip_smoke.REST_DIGEST
