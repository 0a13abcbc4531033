"""Row-sharded activations and their halo exchanges (``--spatial-shard``,
``--eval-spatial-shard``).

The JAX package shards a sample's image rows over the 'space' axis of its
mesh and leaves the rest to GSPMD, which inserts a halo exchange before
every op that reads across rows and a cross-shard reduction under every
reduction over H.  The port runs one process per card, so it writes them
here.  The row rule (core/mesh.py ``band_rows``): an image of H rows over
S ranks, u the path's largest stride, is cut into bands of h = ceil(H /
(S*u)) * u rows; rank s holds rows [s*h, min((s+1)*h, H)), so the last
band or bands are short and a band may be empty.

Each activation lives at a level: its global height H_l, which follows
its layer's own arithmetic (ceil(H/2) for a 3x3 stride-2 padding-1 conv,
floor(H/2) for the discriminator's 4x4 ones), and its band rows h_l =
h / k at stride k; rank s holds rows [s*h_l, min((s+1)*h_l, H_l)).  The
forward carries the levels by width (W is never sharded, and each
stride changes it): ``row_shard`` seeds the input's, each op that
changes the size registers its output's, and ``level(x)`` reads x's.

``row_shard(mesh, height, stride, columns, width)`` is the context in
which a forward runs row-sharded (the idiom of models/layers.py
``bn_real_batch``); without it every layer runs as before and no
collective is called.  Inside it the layers read ``current()``:

- ``gather_rows(x, lo, hi, mesh, pad, level, windows)``: global rows
  [lo, hi) of the H-sharded x, rows outside [0, H_l) `pad` (zero, or
  -inf for a max pool).  The rows may come from ranks that are not
  neighbours (ASPP's dilation 18 reaches past a band of 16 rows at S =
  2).  One all-gather of each rank's edge slabs, as bytes, every slab of
  one shape (a short band pads its slab, an empty one sends pad rows);
  the backward returns each gathered row's gradient to its owner by one
  more, summed in rank order, so the bits repeat.  The plan is made
  from every rank's window, so every rank calls the same collectives.
- ``conv_rows``: a conv (or pool) along H on exactly the rows its
  local output rows read; an empty output band convolves one row of
  pad and keeps none (the collectives and the graph stay every rank's).
  ``halo``: the band plus `width` rows a side (the hand-written kernels,
  which pad their input themselves: their extra output rows are
  cropped).
- ``space_sum``: a sum over the group, in both directions (ASPP's pool).
- ``replicated()``: a region whose tensors are not row-sharded but the
  same on every rank of the group (ASPP's pooled branch at [N, C, 1,
  1]): its train-mode BatchNorm synchronizes over the 'data' group.

The gathers are counted by the mesh (``Mesh.gathers``, ``gathered``: the
elements a rank sent).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from s2r_tpu_torch.core.mesh import band_bounds, band_rows

_local = threading.local()


class RowState(NamedTuple):
    """The row sharding of this thread's forward: `rows`, the mesh over
    which the image rows are sharded (None: not sharded); `columns`, the
    mesh of the ranks holding the same rows of other samples (the
    'data' group); `replicated`: inside ``replicated()``; `levels`: width
    -> (global height, band rows) of every level of the forward."""
    rows: object = None
    columns: object = None
    replicated: bool = False
    levels: Optional[Dict] = None


def state() -> RowState:
    return getattr(_local, "state", RowState())


def set_state(st: RowState) -> None:
    """Set this thread's row sharding (a remat recompute replays its
    forward's, models/layers.py ``remat``)."""
    _local.state = st


def current():
    """The mesh over which the running forward's rows are sharded, or
    None."""
    return state().rows


class _Scope:
    def __init__(self, st: RowState):
        self.st = st

    def __enter__(self):
        self._prev = state()
        set_state(self.st)
        return self.st.rows

    def __exit__(self, *exc):
        set_state(self._prev)


def row_shard(mesh, height: Optional[int] = None, stride: int = 1,
              columns=None, width: Optional[int] = None) -> _Scope:
    """Context manager: the forward inside runs with its rows sharded over
    `mesh` (a core/mesh.py Mesh or a stand-in; None or one process: not
    sharded), `columns` the ranks holding the same rows of the other
    samples (train-mode BatchNorm synchronizes over them in
    ``replicated`` regions; None: no other ranks, one data row).
    `height` is the input's global height and `stride` the path's
    largest stride: the bands are the band rule's (core/mesh.py
    ``band_rows``), any height on any group; required under a mesh.
    `width`, the input's W, names its level (None: the first tensor the
    forward reads)."""
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    levels = None
    if mesh is not None:
        if height is None:
            raise ValueError("row_shard: a row-sharded forward needs the "
                             "input's global height")
        levels = {width: (int(height), band_rows(height, mesh.size,
                                                 stride))}
    return _Scope(RowState(mesh, columns if mesh is not None else None,
                           False, levels))


def replicated() -> _Scope:
    """A region whose tensors are not row-sharded but the same on every
    rank of the row mesh (ASPP's pooled branch at [N, C, 1, 1]): the
    layers run unsharded, and train-mode BatchNorm synchronizes over the
    columns only (its world would count each sample once a band)."""
    st = state()
    if st.rows is None:
        return _Scope(st)
    return _Scope(RowState(None, st.columns, True))


def own_levels(x: torch.Tensor) -> _Scope:
    """A region with levels of its own, seeded with x's (the
    discriminator: its floor(H/2) levels may share a width with the
    segmenter's ceil(H/2) ones)."""
    st = state()
    if st.rows is None:
        return _Scope(st)
    return _Scope(st._replace(levels={x.shape[3]: level(x)}))


def level(x: torch.Tensor) -> Tuple[int, int]:
    """(global height, band rows) of the row-sharded x, by its width; the
    rows x holds are checked against the band rule."""
    return level_of_width(x.shape[3], x.shape[2])


def level_of_width(w: int, n: int) -> Tuple[int, int]:
    """(global height, band rows) of the level of width `w`, of which this
    rank holds `n` rows (checked against the band rule)."""
    st = state()
    mesh, levels = st.rows, st.levels
    if w not in levels:
        if None not in levels:
            raise ValueError(f"row sharding: no level of width {w} (an op "
                             "changed the size without registering it)")
        levels[w] = levels.pop(None)
    height, band = levels[w]
    r0, r1 = band_bounds(height, band, mesh.rank)
    if n != r1 - r0:
        raise ValueError(
            f"row sharding: rank {mesh.rank} of {mesh.size} holds {n} rows "
            f"of a level of {height} (width {w}); the band rule gives "
            f"rows [{r0}, {r1}) of bands of {band}")
    return height, band


def register(width: int, height: int, band: int) -> None:
    """Record a level: width -> (global height, band rows); a width seen
    before must carry the same level."""
    old = state().levels.setdefault(int(width), (int(height), int(band)))
    if old != (height, band):
        raise ValueError(
            f"row sharding: two levels of width {width}, heights "
            f"{old[0]} and {height} (bands {old[1]} and {band}); the "
            "levels of one forward need distinct widths")


def register_strided(y: torch.Tensor, x: torch.Tensor, kernel: int,
                     stride: int, padding: int) -> None:
    """Register the level of y, the output of a conv of x along H (kernel,
    stride, padding)."""
    height, band = level(x)
    register(y.shape[3], out_rows(height, kernel, stride, padding, 1),
             _split(band, stride))


def _split(band: int, stride: int) -> int:
    if band % stride:
        raise ValueError(f"row sharding: a band of {band} rows does not "
                         f"split at stride {stride}; give row_shard the "
                         "path's largest stride")
    return band // stride


@functools.lru_cache(maxsize=1024)
def _plan(windows: Tuple[Tuple[int, int], ...], height: int, band: int,
          rank: int):
    """The gather of rows [lo, hi) = windows[rank] from bands of `band`
    rows of an image of `height` (core/mesh.py ``band_bounds``), every
    rank t gathering windows[t].  Each rank sends its bottom `ta` and top
    `tb` rows (a slab of ta + tb rows; a short band pads it); after the
    all-gather, slab row j of rank t sits at t * (ta + tb) + j of the
    pool, the pad row last.  ta and tb are the most rows any rank's
    window takes from another rank's band above or below its own.
    Returns (ta, tb, the pool index of each gathered row above the band,
    the local rows [a, b) the window keeps, the pool index of each row
    below the band)."""
    size = len(windows)
    bounds = [band_bounds(height, band, t) for t in range(size)]
    need_a = max(b0 - min(max(lo, 0), b0) for (lo, _), (b0, _) in
                 zip(windows, bounds))
    need_b = max(max(min(hi, height), b1) - b1 for (_, hi), (_, b1) in
                 zip(windows, bounds))
    ta, tb = min(need_a, band), min(need_b, band)
    slab, pad = ta + tb, size * (ta + tb)
    (lo, hi), (r0, r1) = windows[rank], bounds[rank]

    def index(g: int) -> int:
        if g < 0 or g >= height:
            return pad
        t, off = divmod(g, band)
        n = bounds[t][1] - bounds[t][0]
        j = off - (n - ta) if g < r0 else ta + off
        assert (0 <= j < ta) if g < r0 else (ta <= j < slab), (g, t, j)
        return t * slab + j

    up = tuple(index(g) for g in range(lo, min(hi, r0)))
    down = tuple(index(g) for g in range(max(lo, r1), hi))
    keep = (min(max(lo, r0), r1) - r0, max(min(hi, r1), r0) - r0)
    return ta, tb, up, keep, down


@functools.lru_cache(maxsize=1024)
def _indices(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """`values` as an int64 tensor on `device`, made once: a copy from the
    host each call would wait for the device."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.long, device=device)


def _slab(x: torch.Tensor, ta: int, tb: int, pad: float) -> torch.Tensor:
    """x's bottom `ta` and top `tb` rows, a short band's filled with `pad`
    (rows never gathered)."""
    n = x.shape[2]
    parts = []
    if ta > n:
        parts.append(x.new_full(x.shape[:2] + (ta - n, x.shape[3]), pad))
    parts += [x[:, :, max(n - ta, 0):], x[:, :, :min(tb, n)]]
    if tb > n:
        parts.append(x.new_full(x.shape[:2] + (tb - n, x.shape[3]), pad))
    return torch.cat(parts, dim=2)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan, mesh, pad: float):
        n, c, h, w = x.shape
        ta, tb, up, (a, b), down = plan
        pool = [x.new_full((n, c, 1, w), pad)]
        if ta + tb:
            pool = mesh.all_gather(_slab(x, ta, tb, pad)) + pool
        pool = torch.cat(pool, dim=2)
        rows = up + down
        halo_rows = (pool.index_select(2, _indices(rows, x.device)) if rows
                     else pool[:, :, :0])
        nu, kept = len(up), b - a
        out = torch.empty((n, c, nu + kept + len(down), w), dtype=x.dtype,
                          device=x.device, memory_format=_format(x))
        out[:, :, :nu] = halo_rows[:, :, :nu]
        out[:, :, nu:nu + kept] = x[:, :, a:b]
        out[:, :, nu + kept:] = halo_rows[:, :, nu:]
        ctx.mesh, ctx.plan, ctx.shape = mesh, plan, x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, (ta, tb, up, (a, b), down) = ctx.mesh, ctx.plan
        n, c, h, w = ctx.shape
        nu, kept = len(up), b - a
        dx = g.new_zeros(ctx.shape)
        dx[:, :, a:b] = g[:, :, nu:nu + kept]
        size, slab = mesh.size, ta + tb
        if not slab:
            return dx, None, None, None
        # the gradient of each gathered row, at its slot of its owner's
        # slab (the pad row's is dropped)
        rows = torch.cat([g[:, :, :nu], g[:, :, nu + kept:]], dim=2)
        keep = [i for i, j in enumerate(up + down) if j < size * slab]
        sent = g.new_zeros((size * slab, n, c, w))
        if keep:
            sent.index_copy_(0, _indices(tuple((up + down)[i] for i in keep),
                                         g.device),
                             rows.permute(2, 0, 1, 3).index_select(
                                 0, _indices(tuple(keep), g.device)))
        parts = mesh.all_gather(sent.view(size, slab, n, c, w))
        acc = torch.promote_types(g.dtype, torch.float32)
        total = parts[0][mesh.rank].to(acc)
        for p in parts[1:]:  # in rank order: the same bits every run
            total = total + p[mesh.rank].to(acc)
        total = total.permute(1, 2, 0, 3)  # [n, c, slab, w]
        # slab row j < ta is band row h - ta + j, row ta + j is band row j
        lo = max(ta - h, 0)
        if ta > lo:
            dx[:, :, h - ta + lo:] = (dx[:, :, h - ta + lo:].to(acc)
                                      + total[:, :, lo:ta]).to(dx.dtype)
        top = min(tb, h)
        if top:
            dx[:, :, :top] = (dx[:, :, :top].to(acc)
                              + total[:, :, ta:ta + top]).to(dx.dtype)
        return dx, None, None, None


def _format(x: torch.Tensor):
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


def gather_rows(x: torch.Tensor, lo: int, hi: int, mesh, pad: float,
                level_of: Tuple[int, int],
                windows: Optional[Sequence[Tuple[int, int]]] = None
                ) -> torch.Tensor:
    """Global rows [lo, hi) of the row-sharded NCHW x over `mesh`, rows
    outside [0, H) filled with `pad`.  `level_of` is x's (global height
    H, band rows) and `windows` every rank's (lo, hi), by rank (None:
    each rank's at the same offsets from its band's start as this
    rank's).  Without rows beyond any rank's band, a slice of x (no
    collective)."""
    height, band = level_of
    if windows is None:
        starts = [band_bounds(height, band, t)[0] for t in range(mesh.size)]
        r0 = starts[mesh.rank]
        windows = tuple((lo - r0 + s, hi - r0 + s) for s in starts)
    windows = tuple((int(a), int(b)) for a, b in windows)
    if windows[mesh.rank] != (lo, hi):
        raise ValueError(f"gather_rows: window {(lo, hi)} is not rank "
                         f"{mesh.rank}'s of {windows}")
    plan = _plan(windows, height, band, mesh.rank)
    ta, tb, up, (a, b), down = plan
    if not (ta or tb or up or down):  # ta and tb are alike on every rank
        return x[:, :, a:b] if (a, b) != (0, x.shape[2]) else x
    return _GatherRows.apply(x, plan, mesh, float(pad))


def halo(x: torch.Tensor, width: int, pad: float = 0.0) -> torch.Tensor:
    """The band of x with `width` rows of its neighbours' a side (`pad`
    outside the image), under the current row mesh.  An empty band takes
    2 * `width` rows of pad."""
    mesh = current()
    height, band = level(x)

    def window(t):
        r0, r1 = band_bounds(height, band, t)
        return (r0 - width, r1 + width) if r1 > r0 else (
            height, height + 2 * width)

    windows = tuple(window(t) for t in range(mesh.size))
    lo, hi = windows[mesh.rank]
    return gather_rows(x, lo, hi, mesh, pad, (height, band), windows)


def out_rows(height: int, kernel: int, stride: int, padding: int,
             dilation: int) -> int:
    """Output rows of a conv over `height` rows."""
    return (height + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def conv_rows(op, x: torch.Tensor, kernel: int, stride: int, padding: int,
              dilation: int = 1, pad: float = 0.0) -> torch.Tensor:
    """op(rows) for the rows of the row-sharded x that this rank's output
    rows of a conv (or pool) along H read, op the conv with row padding
    0: output rows [o0, o1) read rows [o0*stride - padding, (o1 - 1) *
    stride - padding + dilation*(kernel - 1) + 1).  The output is at the
    level of the conv's global arithmetic (registered).  An empty output
    band convolves one row of pad and keeps none."""
    mesh = current()
    height, band = level(x)
    h_out = out_rows(height, kernel, stride, padding, dilation)
    b_out = _split(band, stride)
    extent = dilation * (kernel - 1) + 1

    def window(t):
        o0, o1 = band_bounds(h_out, b_out, t)
        if o1 <= o0:
            return height, height + extent
        return o0 * stride - padding, (o1 - 1) * stride - padding + extent

    windows = tuple(window(t) for t in range(mesh.size))
    lo, hi = windows[mesh.rank]
    o0, o1 = band_bounds(h_out, b_out, mesh.rank)
    y = op(gather_rows(x, lo, hi, mesh, pad, (height, band), windows))
    register(y.shape[3], h_out, b_out)
    return y if o1 > o0 else y[:, :, :0]


class _SpaceSum(torch.autograd.Function):
    """The sum over the mesh of a tensor, whose value every rank then
    holds; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous().clone()), None


def space_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the current row mesh (t itself without one)."""
    mesh = current()
    return t if mesh is None else _SpaceSum.apply(t, mesh)
