"""The depthwise kernels' launch plan (s2r_tpu_torch/ops/kernels/depthwise.py
sweep_plan), checked on the CPU.

The CUDA sweeps (csrc/depthwise.cu) take their tile decomposition from the
wrapper, so it is tested here at every shape the port's paths give them
(MobileNetV2 os16 at 512x1024 batch 8 for the train step, 2048x1024 batch 8
for serving, 513x513 batch 1) and at edge shapes: every output pixel and
channel is covered exactly once, every tap a thread reads lies in its
block's staged rows and columns, shared memory fits a block and dk's
partials fit the scratch the wrapper allocates.  An emulation of the
decomposition in float64 (zero-filled haloed tiles staged as the kernels
stage them, then the taps each thread reads) equals the plain versions.
"""

import itertools

import numpy as np
import pytest
import torch

from s2r_tpu_torch.models.mobilenet import block_plan
from s2r_tpu_torch.ops.kernels import depthwise as dw
from s2r_tpu_torch.ops.kernels.depthwise import (SweepTuning,
                                                 depthwise_conv3x3_plain,
                                                 depthwise_dk_plain,
                                                 dk_scratch_floats,
                                                 staged_cols, staged_rows,
                                                 sweep_plan, tap_col)


def _dw_shapes(hw):
    """(C, H, W, d) of MobileNetV2 os16's 14 stride-1 depthwise convs."""
    h, w = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1
    out = []
    for in_ch, _, stride, dilation, t in block_plan(16):
        if stride == 1:
            out.append((in_ch * t, h, w, dilation))
        else:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return out


TRAIN = [(8, h, w, c, d) for c, h, w, d in _dw_shapes((512, 1024))]
SERVE = [(8, h, w, c, d) for c, h, w, d in _dw_shapes((1024, 2048))]
CHECK_513 = sorted({(1, h, w, c, d) for c, h, w, d in _dw_shapes((513, 513))})
# (N, H, W, C, d, aligned): W and H under a tile, H = W = 1, odd H at d = 2
# (the shapes of ROADMAP C.1), d = 4, C = 7 and unaligned inputs (one
# channel a thread), tile boundaries inside a dilation-2 halo, the
# phase-2f shape whose batch the forward splits, and blocks that stream
# several images shorter than the rows staged ahead.
EDGE = [(2, 5, 3, 64, 1, True), (1, 1, 1, 16, 1, True), (1, 1, 1, 16, 3, True),
        (1, 13, 11, 24, 2, True), (1, 5, 5, 3, 2, True),
        (1, 33, 33, 960, 2, True), (2, 9, 37, 40, 4, True),
        (2, 33, 65, 7, 2, True), (2, 17, 19, 20, 1, True),
        (1, 17, 19, 24, 2, False), (2, 12, 70, 48, 2, True),
        (113, 256, 512, 144, 1, True), (114, 256, 512, 144, 1, True),
        (2500, 2, 3, 16, 1, True)]
ALL = ([s + (True,) for s in TRAIN + SERVE + CHECK_513] + EDGE)
KINDS = ("forward", "dk")


def _check_plan(kind, n, h, w, c, d, itemsize, aligned, tuning=None):
    """Coverage, halos, limits and scratch of one plan; returns it."""
    p = sweep_plan(kind, n, h, w, c, d, itemsize, aligned, tuning)
    assert p.vec >= 1 and c % p.vec == 0
    if aligned:
        want = dw.VEC_BYTES[kind]
        assert p.vec * itemsize == want or c % (want // itemsize)
    if not aligned:
        assert p.vec == 1
    assert p.cols == dw.COLS[kind] and p.tw % p.cols == 0
    assert 1 <= p.nvb * (p.tw // p.cols) <= dw.MAX_THREADS
    assert 1 <= p.ahead <= dw.MAX_AHEAD
    assert p.smem <= dw.MAX_SMEM
    assert 1 <= p.images_grid <= min(n, dw.MAX_IMAGES_GRID)
    assert p.classes == min(d, h)
    assert p.blocks // p.images_grid < 2 ** 31
    assert p.span == p.tw + 2 * min(d, p.tw)
    cb = p.nvb * p.vec
    # channels: chunk x vector x element, each channel once
    chans = np.zeros(c, int)
    for chunk, v in itertools.product(range(p.nchunks), range(p.nvb)):
        ch = chunk * cb + v * p.vec
        if ch < c:
            chans[ch:ch + p.vec] += 1
    assert (chans == 1).all()
    # columns: each output column once, and its taps in the staged row
    cols = np.zeros(w, int)
    for tile in range(p.ntiles):
        staged = staged_cols(p, w, d, tile)
        assert len(staged) == p.span
        for tc in range(p.tw):
            col = tile * p.tw + tc
            if col >= w:
                continue
            cols[col] += 1
            for dx in range(3):
                sc = tap_col(p, d, tc, dx)
                assert 0 <= sc < p.span
                gc = col + (dx - 1) * d
                assert staged[sc] == (gc if 0 <= gc < w else -1)
    assert (cols == 1).all()
    # rows: each output row once, its three input rows staged around it
    rows = np.zeros(h, int)
    for cls, run in itertools.product(range(p.classes), range(p.runs)):
        staged = staged_rows(p, h, d, cls, run)
        for t in range(2, len(staged)):
            r = cls + (run * p.rows + t - 2) * d
            rows[r] += 1
            for dy in range(3):
                gr = r + (dy - 1) * d
                assert staged[t - 2 + dy] == (gr if 0 <= gr < h else -1)
    assert (rows == 1).all()
    assert p.rows * p.runs * d >= h
    # images: blocks y, y + images_grid, ... take each image once
    seen = sorted(i for y in range(p.images_grid)
                  for i in range(y, n, p.images_grid))
    assert seen == list(range(n))
    if kind == "dk":
        blocks_a_chunk = p.ntiles * p.classes * p.runs * p.images_grid
        assert p.slabs == blocks_a_chunk
        assert dk_scratch_floats(p, c) == p.slabs * 9 * c
        # the last slab's partial ends inside the scratch
        assert ((p.slabs - 1) * 9 + 8) * c + c <= dk_scratch_floats(p, c)
        assert not p.fused or p.nchunks <= dw.MAX_CHUNKS
        # the block's column fold fits its shared memory
        assert p.nvb * (p.tw // p.cols) * (9 * p.vec + 1) * 4 <= p.smem
    return p


@pytest.mark.parametrize("shape", ALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_plan_covers_and_fits(kind, shape):
    n, h, w, c, d, aligned = shape
    for itemsize in (2, 4):
        _check_plan(kind, n, h, w, c, d, itemsize, aligned)


def test_plans_fill_the_card_at_the_path_shapes():
    """Every path shape gives a launch of at least one block a SM (132 on
    an H100) and, for dk, few enough partials that the scratch stays
    small."""
    for kind, (n, h, w, c, d) in itertools.product(KINDS, TRAIN + SERVE):
        p = sweep_plan(kind, n, h, w, c, d, 2, True)
        assert p.blocks >= 132, (kind, n, h, w, c, d, p)
        if kind == "dk":
            assert dk_scratch_floats(p, c) * 4 <= 8 * 2 ** 20


def test_dk_scratch_is_sized_by_the_plan_not_a_fixed_slab_count():
    """dk's scratch holds the plan's partials: at C = 960 far fewer than
    a fixed 1024 slabs x 9 x C floats (35 MB)."""
    p = sweep_plan("dk", 8, 32, 64, 960, 2, 2, True)
    assert dk_scratch_floats(p, 960) < 1024 * 9 * 960 // 8


# Plans off the defaults: tiny tiles, so a dilation's halo is wider than
# the tile (three staged segments) and rows split into many runs; and
# long sweeps of several images a block.
TUNINGS = [None,
           SweepTuning(chunk_bytes=32, threads=8, ahead=1, target_blocks=64,
                       min_rows=1, fold_loads=1 << 30),
           SweepTuning(chunk_bytes=16, threads=32, ahead=6, target_blocks=2,
                       min_rows=2, fold_loads=0)]


def _stage(x, plan, d, img, tile, cls, run, chans):
    """The block's staged rows [rows, span, len(chans)], zero off the
    image, as the kernels stage them."""
    rows = staged_rows(plan, x.shape[1], d, cls, run)
    cols = staged_cols(plan, x.shape[2], d, tile)
    out = torch.zeros(len(rows), plan.span, len(chans), dtype=x.dtype)
    for i, r in enumerate(rows):
        for j, gc in enumerate(cols):
            if r >= 0 and gc >= 0:
                out[i, j] = x[img, r, gc, chans]
    return out


def _blocks(plan, c):
    cb = plan.nvb * plan.vec
    for chunk, tile, cls, run in itertools.product(
            range(plan.nchunks), range(plan.ntiles), range(plan.classes),
            range(plan.runs)):
        chans = list(range(chunk * cb, min(c, (chunk + 1) * cb)))
        yield chunk, tile, cls, run, chans


def emulate_forward(x, k, d, plan):
    """y from the forward sweep's staged tiles: output row t - 2 of a run
    adds staged rows t - 2, t - 1, t at the thread's tap columns."""
    n, h, w, c = x.shape
    y = torch.full_like(x, float("nan"))
    for _, tile, cls, run, chans in _blocks(plan, c):
        for img in range(n):
            s = _stage(x, plan, d, img, tile, cls, run, chans)
            for t in range(2, s.shape[0]):
                r = cls + (run * plan.rows + t - 2) * d
                for tc in range(plan.tw):
                    col = tile * plan.tw + tc
                    if col >= w:
                        continue
                    acc = torch.zeros(len(chans), dtype=x.dtype)
                    for dy, dx in itertools.product(range(3), range(3)):
                        acc += (s[t - 2 + dy, tap_col(plan, d, tc, dx)]
                                * k[dy, dx, chans])
                    y[img, r, col, chans] = acc
    return y


def emulate_dk(x, g, d, plan):
    """dk from the dk sweep: per block, staged x row t times g rows t, t-1,
    t-2 as taps dy = 0, 1, 2, summed over the block's images and columns
    into one partial a slab; then the slabs summed."""
    n, h, w, c = x.shape
    part = torch.zeros(plan.slabs, 9, c, dtype=x.dtype)
    per_image = plan.ntiles * plan.classes * plan.runs
    for _, tile, cls, run, chans in _blocks(plan, c):
        for yb in range(plan.images_grid):
            slab = yb * per_image + (cls * plan.runs + run) * plan.ntiles + tile
            for img in range(yb, n, plan.images_grid):
                s = _stage(x, plan, d, img, tile, cls, run, chans)
                nrun = s.shape[0] - 2
                for t in range(s.shape[0]):
                    for dy in range(3):
                        o = t - dy
                        if not 0 <= o < nrun:
                            continue
                        r = cls + (run * plan.rows + o) * d
                        for tc in range(plan.tw):
                            col = tile * plan.tw + tc
                            if col >= w:
                                continue
                            for dx in range(3):
                                part[slab, dy * 3 + dx, chans] += (
                                    s[t, tap_col(plan, d, tc, dx)]
                                    * g[img, r, col, chans])
    return part.sum(0).reshape(3, 3, c)


EMULATED = [(2, 5, 3, 8, 1), (1, 1, 1, 4, 1), (1, 7, 6, 3, 2),
            (2, 9, 10, 6, 4), (1, 6, 11, 7, 2), (2, 12, 13, 16, 2),
            (1, 4, 5, 3, 5)]


@pytest.mark.parametrize("tuning", range(len(TUNINGS)))
@pytest.mark.parametrize("shape", EMULATED,
                         ids=lambda s: "x".join(map(str, s)))
def test_emulated_sweeps_equal_the_plain_versions(shape, tuning):
    n, h, w, c, d = shape
    rng = np.random.RandomState(sum(shape) + tuning)
    x = torch.from_numpy(rng.randn(n, h, w, c))
    g = torch.from_numpy(rng.randn(n, h, w, c))
    k = torch.from_numpy(rng.randn(3, 3, c))
    for itemsize, aligned in ((2, True), (4, True), (4, False)):
        fwd = _check_plan("forward", n, h, w, c, d, itemsize, aligned,
                          TUNINGS[tuning])
        torch.testing.assert_close(emulate_forward(x, k, d, fwd),
                                   depthwise_conv3x3_plain(x, k, d),
                                   rtol=1e-12, atol=1e-12)
        dkp = _check_plan("dk", n, h, w, c, d, itemsize, aligned,
                          TUNINGS[tuning])
        torch.testing.assert_close(emulate_dk(x, g, d, dkp),
                                   depthwise_dk_plain(x, g, d),
                                   rtol=1e-12, atol=1e-12)


def test_tiny_tiles_stage_three_segments_for_a_wide_halo():
    """A dilation wider than the tile stages the three tw-wide segments at
    w0 - d, w0 and w0 + d, not the gap between them."""
    p = sweep_plan("forward", 1, 9, 10, 6, 4, 4, True, TUNINGS[1])
    assert p.tw < 4 and p.span == 3 * p.tw
    cols = staged_cols(p, 10, 4, 2)
    w0 = 2 * p.tw
    assert cols == [gc if 0 <= gc < 10 else -1 for gc in
                    [w0 - 4 + i for i in range(p.tw)]
                    + [w0 + i for i in range(p.tw)]
                    + [w0 + 4 + i for i in range(p.tw)]]
