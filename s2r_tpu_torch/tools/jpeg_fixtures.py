"""The JPEG fixtures of the port's decoder (data/imaging.py ``decode_jpeg``)
and the SHA-256 of PIL's decode of each.

    python -m s2r_tpu_torch.tools.jpeg_fixtures     # needs PIL (Pillow)

writes ``s2r_tpu_torch/data/jpeg_fixtures/*.jpg`` and ``digests.json``
({name: sha256 of np.asarray(Image.open(f).convert("RGB")).tobytes(),
and its [H, W, 3] shape}).  The card's machine has no PIL: chip_smoke.py
holds the decoder built there to these digests, and
tests/test_torch_port_jpeg.py holds them to PIL here.  Every file is made
with PIL from seeded arrays, at odd sizes, one of each kind the decoder
takes: baseline at 4:4:4, 4:2:2, 4:2:0 and 4:1:1, gray, progressive
(color and gray, with successive approximation), restart intervals (by
blocks and by rows, baseline and progressive), 1x1 and 2x3 frames (the
box upsampling of chroma 2 samples wide or less), 4:4:0 (PIL writes none:
a 4:2:2 file with its factors swapped and its size set to keep the MCU
count, so libjpeg's h1v2 filter runs), the RGB color space (no JFIF,
components named 'R' 'G' 'B'; an Adobe marker with transform 0), and
``frame_2048x1024.jpg``, a smooth full-size frame for timing.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Callable, Dict

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "jpeg_fixtures")
BIG = "frame_2048x1024.jpg"


def _noisy(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients under noise: uint8 [h, w, 3]."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 7 % 256], -1)
    return (base + rs.randint(-40, 40, (h, w, 3))).clip(0, 255).astype(
        np.uint8)


def _smooth(h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.stack([128 + 100 * np.sin(x / 97 + y / 53),
                  128 + 90 * np.cos(x / 41 - y / 77),
                  128 + 80 * np.sin((x + y) / 131)], -1)
    return a.clip(0, 255).astype(np.uint8)


def _save(a: np.ndarray, gray: bool = False, **kw) -> bytes:
    from PIL import Image

    im = Image.fromarray(a)
    if gray:
        im = im.convert("L")
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _drop_jfif(d: bytearray) -> bytearray:
    i = d.index(b"\xff\xe0")
    return d[:i] + d[i + 2 + int.from_bytes(d[i + 2:i + 4], "big"):]


def _rgb_ids(data: bytes) -> bytes:
    """No JFIF marker and components named 'R' 'G' 'B': libjpeg takes the
    samples as RGB."""
    d = _drop_jfif(bytearray(data))
    i = d.index(b"\xff\xc0")
    j = d.index(b"\xff\xda")
    for c in range(3):
        d[i + 10 + 3 * c] = d[j + 5 + 2 * c] = b"RGB"[c]
    return bytes(d)


def _adobe_rgb(data: bytes) -> bytes:
    """An Adobe APP14 marker with transform 0 in place of JFIF: RGB."""
    d = bytearray(data)
    i = d.index(b"\xff\xe0")
    seg = int.from_bytes(d[i + 2:i + 4], "big")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return bytes(d[:i] + adobe + d[i + 2 + seg:])


def _h1v2(data: bytes, trim: int) -> bytes:
    """A 4:2:2 (h2v1) file relabeled 4:4:0 (h1v2): the MCU holds the same
    blocks, so the scan decodes; the size keeps the MCU grid, `trim`
    samples short of it in each direction."""
    d = bytearray(data)
    i = d.find(b"\xff\xc0")
    i = i if i >= 0 else d.index(b"\xff\xc2")
    h = int.from_bytes(d[i + 5:i + 7], "big")
    w = int.from_bytes(d[i + 7:i + 9], "big")
    mx, my = -(-w // 16), -(-h // 8)
    d[i + 5:i + 7] = (my * 16 - trim).to_bytes(2, "big")
    d[i + 7:i + 9] = (mx * 8 - trim).to_bytes(2, "big")
    assert d[i + 11] == 0x21
    d[i + 11] = 0x12
    return bytes(d)


def fixtures() -> Dict[str, Callable[[], bytes]]:
    """{file name: a function making its bytes}."""
    return {
        "base_420_37x29.jpg": lambda: _save(_noisy(29, 37, 1), quality=75),
        "base_422_45x23.jpg": lambda: _save(_noisy(23, 45, 2), quality=90,
                                            subsampling=1),
        "base_444_31x17.jpg": lambda: _save(_noisy(17, 31, 3), quality=95,
                                            subsampling=0),
        "base_411_41x19.jpg": lambda: _save(_noisy(19, 41, 4), quality=85,
                                            subsampling="4:1:1"),
        "base_q100_444_13x11.jpg": lambda: _save(_noisy(11, 13, 5),
                                                 quality=100, subsampling=0),
        "gray_23x35.jpg": lambda: _save(_noisy(35, 23, 6), gray=True,
                                        quality=80),
        "prog_420_53x37.jpg": lambda: _save(_noisy(37, 53, 7), quality=75,
                                            progressive=True),
        "prog_444_29x31.jpg": lambda: _save(_noisy(31, 29, 8), quality=92,
                                            subsampling=0, progressive=True),
        "prog_gray_19x21.jpg": lambda: _save(_noisy(21, 19, 9), gray=True,
                                             quality=70, progressive=True),
        "rst_blocks_420_33x47.jpg": lambda: _save(
            _noisy(47, 33, 10), quality=80, restart_marker_blocks=1),
        "rst_rows_prog_422_39x27.jpg": lambda: _save(
            _noisy(27, 39, 11), quality=85, subsampling=1,
            restart_marker_rows=1, progressive=True),
        "tiny_420_1x1.jpg": lambda: _save(_noisy(1, 1, 12), quality=90),
        "tiny_420_2x3.jpg": lambda: _save(_noisy(3, 2, 13), quality=90),
        "h1v2_13x45.jpg": lambda: _h1v2(_save(_noisy(21, 30, 14),
                                              quality=85, subsampling=1), 3),
        "h1v2_prog_29x78.jpg": lambda: _h1v2(_save(
            _noisy(39, 60, 15), quality=80, subsampling=1,
            progressive=True), 3),
        "rgb_ids_21x19.jpg": lambda: _rgb_ids(_save(
            _noisy(19, 21, 16), quality=90, subsampling=0)),
        "adobe_rgb_21x19.jpg": lambda: _adobe_rgb(_save(
            _noisy(19, 21, 17), quality=90, subsampling=0)),
        BIG: lambda: _save(_smooth(1024, 2048), quality=90),
    }


def pil_digest(data: bytes) -> Dict:
    """SHA-256 and shape of ``np.asarray(Image.open(f).convert("RGB"))``."""
    from PIL import Image

    a = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "shape": list(a.shape)}


def main() -> Dict:
    os.makedirs(OUT, exist_ok=True)
    digests = {}
    for name, make in fixtures().items():
        data = make()
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        digests[name] = pil_digest(data)
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(digests)} fixtures in {OUT}")
    return digests


if __name__ == "__main__":
    main()
