"""The port's PNG decoder (csrc/host/png.h) on both routes against PIL and
libpng, on the CPU: Adam7 files, 16-bit files, and the native route's
label decode.

This environment has PIL and builds the JAX package's native library
(s2r_tpu/native, libpng); the port uses neither.  Every comparison is
exact:
- the PIL route (data/imaging.py): Adam7 files at every depth and color
  type the decoder takes, and 16-bit RGB, RGBA and gray+alpha where
  Pillow gives the samples' high bytes, as ``np.asarray(Image.open(p))``
  and ``.convert("RGB")`` give them;
- the native route (data/native.py ``decode_png``): channels 3 and 1 of
  every kind, interlaced or not, 16-bit included (libpng's strip_16), as
  the JAX package's libpng decoder gives them, except palette files at
  channels 1, and files with a tRNS chunk, which the JAX decoder refuses
  and the port decodes as PIL's convert("RGB") does;
- P-mode labels: the port gives the palette indices, as
  ``np.asarray(Image.open(p))`` and the JAX PIL path read them, where the
  JAX native decoder gives the luma of the palette colours (ROADMAP C.12).
"""

import io

import numpy as np
import pytest
from PIL import Image

from s2r_tpu import native as JN
from s2r_tpu_torch.data import imaging
from s2r_tpu_torch.data import native as PN
from test_torch_port_imaging import KINDS, _hand_png

DEEP = [(0, 16), (2, 16), (4, 16), (6, 16)]
CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _kind_png(rs, hw, color, depth, interlace, filters=(0, 1, 2, 3, 4)):
    shape = hw if CH[color] == 1 else hw + (CH[color],)
    samples = rs.randint(0, 2 ** depth, shape)
    palette = None
    if color == 3:
        palette = rs.randint(0, 256, (2 ** depth, 3)).astype(np.uint8)
    return samples, _hand_png(samples, color, depth, filters, palette,
                              interlace=interlace)


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (7, 13), (37, 53)])
def test_decode_adam7(hw):
    """Adam7 files at every depth and color type the decoder takes, each
    pass filtered with the five filters in turn, against PIL."""
    rs = np.random.RandomState(hw[0] * 31 + hw[1])
    for color, depth in KINDS + [(2, 16), (6, 16), (4, 16)]:
        _, data = _kind_png(rs, hw, color, depth, 1)
        im = Image.open(io.BytesIO(data))
        assert im.info.get("interlace") == 1
        np.testing.assert_array_equal(imaging.decode_png(data, True),
                                      np.asarray(im.convert("RGB")))
        if not (depth == 16 and color == 4):
            np.testing.assert_array_equal(imaging.decode_png(data, False),
                                          np.asarray(im, np.uint8))


@pytest.mark.parametrize("color", [2, 4, 6])
def test_decode_16_bit_as_pil(color):
    """16-bit RGB and RGBA decode to Pillow's bytes raw and as RGB (the
    high byte of each sample), 16-bit gray+alpha as RGB; filters cycled."""
    rs = np.random.RandomState(color)
    for hw in ((1, 1), (5, 6), (37, 53)):
        samples, data = _kind_png(rs, hw, color, 16, 0)
        im = Image.open(io.BytesIO(data))
        rgb = imaging.decode_png(data, True)
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))
        hi = (samples >> 8).astype(np.uint8)
        np.testing.assert_array_equal(
            rgb, hi[..., :3] if CH[color] >= 3
            else np.repeat(hi[..., :1], 3, -1))
        if color != 4:
            np.testing.assert_array_equal(imaging.decode_png(data, False),
                                          np.asarray(im))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (37, 53)])
def test_native_decode_equals_libpng(hw, interlace):
    """data/native.py decode_png against the JAX package's libpng decoder:
    RGB of every kind, one channel of every kind but palette (gray, gray +
    alpha, the luma of RGB and RGBA, 16 bits as their high bytes)."""
    rs = np.random.RandomState(hw[0] + 7 * hw[1] + interlace)
    for color, depth in KINDS + DEEP:
        _, data = _kind_png(rs, hw, color, depth, interlace)
        for channels in (3, 1):
            if channels == 1 and color == 3:
                continue  # test_palette_labels_give_indices
            got = PN.decode_png(data, channels)
            want = JN.decode_png(data, channels)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want,
                                          f"{color}/{depth} x{channels}")


def _saved(im, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, "PNG", **kw)
    return b.getvalue()


def test_native_decode_pil_written_with_trns():
    """PIL-written files: LA and RGBA decode on the native route as libpng
    decodes them.  The JAX decoder refuses every file with a tRNS chunk
    (RGB, L and P: its tRNS_to_alpha adds an alpha channel that it strips
    only from color types that had one, and its row length check fails);
    the port decodes them as the same file without tRNS, which is what
    PIL's convert("RGB") gives, and a P-mode label's indices (ROADMAP
    C.12)."""
    base = Image.fromarray(np.random.RandomState(4).randint(
        0, 256, (21, 33, 3)).astype(np.uint8))
    for im in (base.convert("LA"), base.convert("RGBA")):
        for channels in (3, 1):
            np.testing.assert_array_equal(
                PN.decode_png(_saved(im), channels),
                JN.decode_png(_saved(im), channels))
    pal = base.quantize(16)
    for im, trns in ((base, (1, 2, 3)), (base.convert("L"), 7),
                     (pal, bytes([0, 128]))):
        data, plain = _saved(im, transparency=trns), _saved(im)
        assert b"tRNS" in data and b"tRNS" not in plain
        for channels in (3, 1):
            with pytest.raises(ValueError, match="rc=3"):
                JN.decode_png(data, channels)
            want = (np.asarray(pal) if channels == 1 and im is pal
                    else JN.decode_png(plain, channels))
            np.testing.assert_array_equal(PN.decode_png(data, channels),
                                          want)
        np.testing.assert_array_equal(
            PN.decode_png(data, 3),
            np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_palette_labels_give_indices(tmp_path, bits):
    """A P-mode label decodes to its palette indices on the native route,
    as PIL reads it, from a path and from bytes; the JAX native decoder
    gives the luma of the palette colours on the same file (ROADMAP
    C.12).  An L-mode file of the same values decodes equal on both."""
    rs = np.random.RandomState(bits)
    idx = rs.randint(0, 2 ** bits, (9, 14)).astype(np.uint8)
    idx.flat[:5] = np.array([0, 3, 3, 9, 19]) % 2 ** bits
    im = Image.fromarray(idx, "P")
    pal = rs.randint(0, 256, 768).astype(np.uint8)
    pal[:3] = [128, 64, 32]  # no gray entry: luma and index differ
    im.putpalette(pal.tolist())
    path = tmp_path / "label.png"
    im.save(path, bits=bits) if bits < 8 else im.save(path)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil, idx)
    np.testing.assert_array_equal(PN.decode_png(str(path), 1), idx)
    np.testing.assert_array_equal(PN.decode_png(path.read_bytes(), 1), idx)
    jax_native = JN.decode_png(str(path), 1)
    assert not np.array_equal(jax_native, idx)
    gray = tmp_path / "gray.png"
    Image.fromarray(idx, "L").save(gray)
    np.testing.assert_array_equal(PN.decode_png(str(gray), 1),
                                  JN.decode_png(str(gray), 1))


def test_decode_errors_name_the_file(tmp_path):
    """No fallback: a missing file, a file that is not a PNG, a broken CRC
    and a truncated stream raise, naming the file."""
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="bad.png: not a PNG"):
        PN.decode_png(str(bad), 3)
    with pytest.raises(FileNotFoundError):
        PN.decode_png(str(tmp_path / "missing.png"), 3)
    _, data = _kind_png(np.random.RandomState(0), (8, 8), 2, 8, 0)
    crc = bytearray(data)
    crc[-20] ^= 1  # inside the IDAT body
    with pytest.raises(ValueError, match="CRC"):
        PN.decode_png(bytes(crc), 3)
    with pytest.raises(ValueError, match="CRC"):
        imaging.decode_png(bytes(crc), True, "crc.png")


@pytest.mark.parametrize("wh", [(100000, 100000), (2 ** 31 - 1, 3),
                                (2 ** 31 - 1, 2 ** 31 - 1)])
def test_impossible_headers_raise_before_allocating(tmp_path, wh):
    """A header asking for more image bytes than its file could inflate
    to (deflate expands at most 1032-fold), or past the PNG limits, is
    refused before anything is allocated for it, on both routes and in a
    batch call."""
    import struct
    import zlib

    from s2r_tpu_torch.data.datasets import _LUT
    from s2r_tpu_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", *wh, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"\0" * 64))
            + chunk(b"IEND", b""))
    path = tmp_path / "huge.png"
    path.write_bytes(data)
    msg = "wrong length|IHDR"
    for channels in (3, 1):
        with pytest.raises((ValueError, MemoryError)):
            PN.decode_png(data, channels)
    with pytest.raises((ValueError, MemoryError)):
        imaging.decode_png(data, True, "huge.png")
    with pytest.raises(ValueError, match=f"image .*huge.png: .*(?:{msg})"):
        PN.eval_batch([str(path)], None, 8, _LUT, IMAGENET_MEAN,
                      IMAGENET_STD)
