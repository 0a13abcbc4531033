"""The port's native pipeline (data/native.py over csrc/host/pipeline.cpp)
against the JAX package's (s2r_tpu/native, built here with libpng), on the
CPU, on small PNGs made from a seed with L-mode labels.

- ``train_batch`` over seeds, for every combination of: the forced draws
  on and off, the blur on and off, emit_u8 on and off, a square and a
  rectangular crop, with and without targets, and frames larger than the
  crop or smaller (the 0 / 255 pad).  Labels are bytes-equal always, and
  images too where no blur ran.  The JAX library builds with
  -march=native, where g++ fuses multiply-adds into FMAs; the port's flags
  forbid contraction.  So:
  - float32 images differ by at most 2.4e-7 (one float32 ulp at |x| < 4)
    in about two elements of three: normalize's x * scale + bias is one
    FMA there, two roundings here (the port's float32 equals numpy's two
    roundings on its own uint8 output, exactly);
  - the blur's float accumulation, fused there, may round a pixel to the
    next byte: at most 1 LSB in at most 1e-4 of a blurred output's
    elements (the golden digest's inputs: 1 of 69120 elements of one
    blurred batch; the 64 cases here: none), that is 1 / (255 std) <=
    0.0175 more on a float32 image.
- ``eval_batch`` with labels and without (labels of 255), same bounds.
- ``resize_bilinear``, ``resize_nearest``, ``remap`` equal;
  ``normalize`` within the bound above and equal to numpy's two roundings.
- The golden digest that chip_smoke.py phase 11 holds the card to: the
  port gives it here, and the same outputs equal JAX's (bounds above).
- A missing file or an undecodable PNG raises, naming the file; nothing
  falls back.
"""

import itertools
import os
import sys

import numpy as np
import pytest

from s2r_tpu import native as JN
from s2r_tpu_torch.data import native as PN
from s2r_tpu_torch.data.datasets import _LUT
from s2r_tpu_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD
from s2r_tpu_torch.utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ULP_BOUND = 2.4e-7  # float32 images: one ulp at |x| < 4 (normalize's FMA)
LSB = 1 / (255 * min(IMAGENET_STD))  # one byte of a normalized image
BLUR_SHARE = 1e-4  # of a blurred output's elements, one byte apart
N = 5


def _two_roundings(u8: np.ndarray) -> np.ndarray:
    """The port's normalize: x * (1 / (255 std)) + (-mean / std), each op
    rounded to float32."""
    std = np.asarray(IMAGENET_STD, np.float32)
    scale = np.float32(1.0) / (np.float32(255.0) * std)
    bias = -np.asarray(IMAGENET_MEAN, np.float32) / std
    return (u8.astype(np.float32) * scale).astype(np.float32) + bias


def _assert_close(got, want, blurred=False):
    """The bounds of the module docstring: labels and unblurred bytes
    equal; float32 within an ulp; a blurred output's bytes within one in
    at most BLUR_SHARE of its elements."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    step = LSB if got.dtype == np.float32 else 1.0
    tol = ULP_BOUND if got.dtype == np.float32 else 0.0
    off = diff > tol
    if not blurred:
        assert not off.any(), diff.max()
        return
    assert diff.max() <= step + tol, diff.max()
    assert off.mean() <= BLUR_SHARE, off.mean()


def _write_set(root, small: bool, seed: int):
    """N source frames, their L-mode labelId labels and N targets of other
    sizes; `small`: every frame smaller than the crops at base 24."""
    rs = np.random.RandomState(seed)
    lo, hi = ((10, 24) if small else (30, 90))
    paths = {"src": [], "lbl": [], "tgt": []}
    for i in range(N):
        h, w, th, tw = (int(v) for v in rs.randint(lo, hi, 4))
        frames = {"src": rs.randint(0, 256, (h, w, 3)),
                  "lbl": rs.randint(0, 34, (h, w)),
                  "tgt": rs.randint(0, 256, (th, tw, 3))}
        for kind, a in frames.items():
            paths[kind].append(os.path.join(root, f"{kind}{i}.png"))
            write_png(paths[kind][-1], a.astype(np.uint8),
                      filters=(0, 1, 2, 3, 4))
    return paths


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    out = {}
    for small in (False, True):
        d = root / f"small{int(small)}"
        d.mkdir()
        out[small] = _write_set(str(d), small, seed=int(small))
    return out


def _forced(paths, base, crop, seed):
    """Valid (flip, short_size, x1, y1) draws for each source."""
    rs = np.random.RandomState(seed)
    ch, cw = (crop, crop) if isinstance(crop, int) else crop
    rows = []
    for p in paths:
        h, w = PN.decode_png(p, 3).shape[:2]
        short = int(rs.randint(base // 2, 2 * base + 1))
        ow, oh = ((short, int(1.0 * h * short / w)) if h > w
                  else (int(1.0 * w * short / h), short))
        rows.append([int(rs.randint(2)), short,
                     int(rs.randint(0, max(ow, cw) - cw + 1)),
                     int(rs.randint(0, max(oh, ch) - ch + 1))])
    return np.asarray(rows, np.int32)


CASES = list(itertools.product([False, True], [False, True], [False, True],
                               [32, (24, 40)], [True, False],
                               [False, True]))


@pytest.mark.parametrize("forced,blur,emit_u8,crop,targets,small", CASES)
def test_train_batch_matches_jax(sets, forced, blur, emit_u8, crop, targets,
                                 small):
    paths = sets[small]
    base = 24 if small else 40
    tgts = paths["tgt"] if targets else None
    for seed in range(3):
        seeds = np.random.RandomState(seed).randint(
            0, 2 ** 63, N, dtype=np.int64).astype(np.uint64)
        kw = dict(seeds=seeds, blur=blur, emit_u8=emit_u8, threads=2,
                  forced=_forced(paths["src"], base, crop, seed)
                  if forced else None)
        args = (paths["src"], paths["lbl"], tgts, base, crop, _LUT,
                IMAGENET_MEAN, IMAGENET_STD)
        got, want = PN.train_batch(*args, **kw), JN.train_batch(*args, **kw)
        assert (got[2] is None) == (want[2] is None) == (not targets)
        u8 = PN.train_batch(*args, **dict(kw, emit_u8=True))
        blurred = blur and not forced
        for k, (g, w, raw) in enumerate(zip(got, want, u8)):
            if w is None:
                continue
            _assert_close(g, w, blurred and k != 1)
            if w.dtype == np.float32:
                np.testing.assert_array_equal(g, _two_roundings(raw))
        if small:  # the pad: image 0, label 255 (trainId and labelId)
            assert (u8[1] == 255).any() and (u8[0] == 0).all(-1).any()


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("small", [False, True])
def test_eval_batch_matches_jax(sets, labels, small):
    paths = sets[small]
    lbls = paths["lbl"] if labels else None
    for crop in (17, 48):
        got = PN.eval_batch(paths["src"], lbls, crop, _LUT, IMAGENET_MEAN,
                            IMAGENET_STD, 3)
        want = JN.eval_batch(paths["src"], lbls, crop, _LUT, IMAGENET_MEAN,
                             IMAGENET_STD, 3)
        _assert_close(got[0], want[0])
        assert got[1].dtype == np.int32
        _assert_close(got[1], want[1])
        if not labels:
            assert (got[1] == 255).all()


def test_small_functions_match_jax():
    rs = np.random.RandomState(0)
    for shape in ((13, 29, 3), (40, 7), (1, 1, 3), (64, 48, 3)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        for size in ((5, 9), (13, 29), (71, 33), (1, 1), (128, 96)):
            for fn in ("resize_bilinear", "resize_nearest"):
                got = getattr(PN, fn)(img, size)
                want = getattr(JN, fn)(img, size)
                assert got.dtype == np.uint8 and got.shape == want.shape
                np.testing.assert_array_equal(got, want, f"{fn} {shape}")
    labels = rs.randint(0, 256, (17, 23)).astype(np.uint8)
    np.testing.assert_array_equal(PN.remap(labels, _LUT),
                                  JN.remap(labels, _LUT))
    rgb = rs.randint(0, 256, (19, 31, 3)).astype(np.uint8)
    got = PN.normalize(rgb, IMAGENET_MEAN, IMAGENET_STD)
    _assert_close(got, JN.normalize(rgb, IMAGENET_MEAN, IMAGENET_STD))
    np.testing.assert_array_equal(got, _two_roundings(rgb))


def test_golden_digest(tmp_path):
    """chip_smoke.py phase 11 holds the card's outputs to NATIVE_DIGEST;
    the port gives it here, and its outputs are JAX's within the bounds."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    digest, got = chip_smoke.native_digest(PN, str(tmp_path / "p"))
    _, want = chip_smoke.native_digest(JN, str(tmp_path / "j"))
    assert digest == chip_smoke.NATIVE_DIGEST
    assert len(got) == len(want) == 14
    labels = (1, 4, 7, 9, 11, 13)  # the rest: train images (blurred), then
    for k, (g, w) in enumerate(zip(got, want)):  # eval images (k 10, 12)
        _assert_close(g, w, blurred=k < 10 and k not in labels)


def test_failures_name_the_file(sets, tmp_path):
    """No fallback: the failed item's file is named, whichever it is."""
    paths = sets[False]
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    missing = str(tmp_path / "missing.png")
    args = (40, 32, _LUT, IMAGENET_MEAN, IMAGENET_STD)
    for which, i in (("src", 2), ("lbl", 0), ("tgt", 4)):
        p = {k: list(v) for k, v in paths.items()}
        p[which][i] = missing
        name = {"src": "image", "lbl": "label", "tgt": "target"}[which]
        with pytest.raises(ValueError, match=f"item {i}, {name} "
                           f".*missing.png: cannot be read"):
            PN.train_batch(p["src"], p["lbl"], p["tgt"], *args)
    with pytest.raises(ValueError, match="item 1, label .*bad.png: a PNG without"):
        PN.eval_batch(paths["src"][:3], [paths["lbl"][0], str(bad),
                                         paths["lbl"][2]], 16, _LUT,
                      IMAGENET_MEAN, IMAGENET_STD)


def test_thread_count_does_not_change_the_batch(sets):
    """The pool's workers share the next-item counter and the failure
    record: 32 threads on 30 items (more threads than cores) give the
    bytes one thread gives, and a batch whose items all fail names one
    of them."""
    paths = {k: v * 6 for k, v in sets[False].items()}
    args = (paths["src"], paths["lbl"], paths["tgt"], 40, 32, _LUT,
            IMAGENET_MEAN, IMAGENET_STD)
    seeds = np.arange(30, dtype=np.uint64) * 11
    one = PN.train_batch(*args, seeds=seeds, emit_u8=True, threads=1)
    many = PN.train_batch(*args, seeds=seeds, emit_u8=True, threads=32)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)
    gone = ["/nonexistent/f%d.png" % i for i in range(30)]
    with pytest.raises(ValueError, match=r"item \d+, image /nonexistent/f"):
        PN.train_batch(gone, paths["lbl"], None, 40, 32, _LUT,
                       IMAGENET_MEAN, IMAGENET_STD, threads=32)


def test_bad_arguments_raise():
    """Sizes are checked before a pointer reaches the C side."""
    with pytest.raises(ValueError, match="256 entries"):
        PN.remap(np.zeros(4, np.uint8), np.zeros(255, np.uint8))
    with pytest.raises(ValueError, match="3 each"):
        PN.normalize(np.zeros((2, 3), np.uint8), (0, 0), (1, 1, 1))
    with pytest.raises(ValueError, match="paths for a batch of 2"):
        PN.eval_batch(["a", "b"], ["a"], 8, _LUT, IMAGENET_MEAN,
                      IMAGENET_STD)
    with pytest.raises(ValueError, match=r"expected \(2,\), \(2, 4\)"):
        PN.train_batch(["a", "b"], ["a", "b"], None, 8, 8, _LUT,
                       IMAGENET_MEAN, IMAGENET_STD, seeds=[1, 2, 3])
