"""Row-sharded activations and their halo exchanges (``--spatial-shard``,
``--eval-spatial-shard``).

The JAX package shards a sample's image rows over the 'space' axis of its
mesh and leaves the rest to GSPMD, which inserts a halo exchange before
every op that reads across rows and a cross-shard reduction under every
reduction over H.  The port runs one process per card, so it writes them
here.  The row rule: a tensor of global height H over S ranks holds rows
[s*H/S, (s+1)*H/S) on rank s of the group (core/mesh.py ``Layout.band``).

``row_shard(mesh)`` is the context in which a forward runs row-sharded
(the idiom of models/layers.py ``bn_real_batch``); without it every layer
runs as before and no collective is called.  Inside it the layers read
``current()``:

- ``gather_rows(x, lo, hi, mesh, pad)``: global rows [lo, hi) of the
  H-sharded x, rows outside [0, H) `pad` (zero, or -inf for a max pool).
  The rows may come from ranks that are not neighbours (ASPP's dilation
  18 reaches past a shard of 16 rows at S = 2).  One all-gather of each
  rank's edge slabs, as bytes; the backward returns each gathered row's
  gradient to its owner by one more, summed in rank order, so the bits
  repeat.  ``lo`` and ``hi`` must sit at the same offsets from every
  rank's band (each rank must gather the same slab shapes).
- ``conv_input``: exactly the rows a conv's local output rows read (the
  dense convs, the max pool); ``halo``: the band plus `width` rows a side
  (the hand-written kernels, which pad their input themselves: their
  extra output rows are cropped).
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
from typing import NamedTuple, Optional, Tuple

import torch

from s2r_tpu_torch.core.mesh import check_rows

_local = threading.local()


class RowState(NamedTuple):
    """The row sharding of this thread's forward: `rows`, the mesh over
    which the image rows are sharded (None: not sharded); `columns`, the
    mesh of the ranks holding the same rows of other samples (the
    'data' group); `replicated`: inside ``replicated()``."""
    rows: object = None
    columns: object = None
    replicated: bool = False


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
              columns=None) -> _Scope:
    """Context manager: the forward inside runs with its rows sharded over
    `mesh` (a core/mesh.py Mesh or a stand-in; None or one process: not
    sharded), `columns` the ranks holding the same rows of the other
    samples (train-mode BatchNorm synchronizes over them in
    ``replicated`` regions; None: no other ranks, one data row).
    `height`, when given, is the global image height, refused unless
    divisible by the group's size times `stride`, the path's largest
    stride (core/mesh.py ``check_rows``)."""
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    if mesh is not None and height is not None:
        check_rows(int(height), mesh.size, int(stride))
    return _Scope(RowState(mesh, columns if mesh is not None else None))


def replicated() -> _Scope:
    """A region whose tensors are not row-sharded but the same on every
    rank of the row mesh (ASPP's pooled branch at [N, C, 1, 1]): the
    layers run unsharded, and train-mode BatchNorm synchronizes over the
    columns only (its world would count each sample once a band)."""
    st = state()
    if st.rows is None:
        return _Scope(st)
    return _Scope(RowState(None, st.columns, True))


@functools.lru_cache(maxsize=512)
def _plan(h: int, size: int, rank: int, above: int, below: int):
    """The gather of rows [r0 - above, r1 + below) on rank `rank` of
    `size`, bands of `h` rows.  Each rank sends its bottom `ta` and top
    `tb` rows (a slab of ta + tb rows); after the all-gather, slab row j
    of rank t sits at t * (ta + tb) + j of the pool, the pad row last.
    Returns (ta, tb, the pool index of each gathered row above the band,
    of each below it)."""
    ta, tb = min(max(above, 0), h), min(max(below, 0), h)
    r0, r1, height = rank * h, (rank + 1) * h, size * h
    slab, pad = ta + tb, size * (ta + tb)

    def index(g: int, j_of) -> int:
        if g < 0 or g >= height:
            return pad
        t, off = divmod(g, h)
        return t * slab + j_of(off)

    up = [index(g, lambda off: off - (h - ta))
          for g in range(r0 - max(above, 0), r0)]
    down = [index(g, lambda off: ta + off)
            for g in range(r1, r1 + max(below, 0))]
    return ta, tb, tuple(up), tuple(down)


@functools.lru_cache(maxsize=1024)
def _indices(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """`values` as an int64 tensor on `device`, made once: a copy from the
    host each call would wait for the device."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.long, device=device)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, above: int, below: int, mesh, pad: float):
        n, c, h, w = x.shape
        ta, tb, up, down = _plan(h, mesh.size, mesh.rank, above, below)
        top, bottom = max(-above, 0), h - max(-below, 0)
        slab = torch.cat([x[:, :, h - ta:], x[:, :, :tb]], dim=2)
        pool = torch.cat(mesh.all_gather(slab)
                         + [x.new_full((n, c, 1, w), pad)], dim=2)
        halo_rows = pool.index_select(2, _indices(up + down, x.device))
        a = len(up)
        out = torch.empty((n, c, a + bottom - top + len(down), w),
                          dtype=x.dtype, device=x.device,
                          memory_format=_format(x))
        out[:, :, :a] = halo_rows[:, :, :a]
        out[:, :, a:a + bottom - top] = x[:, :, top:bottom]
        out[:, :, a + bottom - top:] = halo_rows[:, :, a:]
        ctx.mesh, ctx.plan, ctx.a = mesh, (ta, tb, up, down), a
        ctx.crop, ctx.shape = (top, bottom), x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, (ta, tb, up, down), a = ctx.mesh, ctx.plan, ctx.a
        top, bottom = ctx.crop
        n, c, h, w = ctx.shape
        size, slab = mesh.size, ta + tb
        dx = g.new_zeros(ctx.shape)
        dx[:, :, top:bottom] = g[:, :, a:a + bottom - top]
        # the gradient of each gathered row, at its slot of its owner's
        # slab (the pad row's is dropped)
        rows = torch.cat([g[:, :, :a], g[:, :, a + bottom - top:]], dim=2)
        keep = [i for i, j in enumerate(up + down) if j < size * slab]
        sent = g.new_zeros((size * slab, n, c, w))
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
        if ta:
            dx[:, :, h - ta:] = (dx[:, :, h - ta:].to(acc)
                                 + total[:, :, :ta]).to(dx.dtype)
        if tb:
            dx[:, :, :tb] = (dx[:, :, :tb].to(acc)
                             + total[:, :, ta:]).to(dx.dtype)
        return dx, None, None, None, None


def _format(x: torch.Tensor):
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


def gather_rows(x: torch.Tensor, lo: int, hi: int, mesh,
                pad: float = 0.0) -> torch.Tensor:
    """Global rows [lo, hi) of the row-sharded NCHW x over `mesh` (rank s
    holds rows [s*h, (s+1)*h)), rows outside [0, H) filled with `pad`.
    Without rows beyond the band, a slice of x (no collective)."""
    h = x.shape[2]
    r0 = mesh.rank * h
    above, below = r0 - lo, hi - (r0 + h)
    if above <= 0 and below <= 0:
        return x[:, :, -above:h + below] if above or below else x
    return _GatherRows.apply(x, above, below, mesh, float(pad))


def halo(x: torch.Tensor, width: int, pad: float = 0.0) -> torch.Tensor:
    """The band of x with `width` rows of its neighbours' a side (`pad`
    outside the image), under the current row mesh."""
    mesh = current()
    r0 = mesh.rank * x.shape[2]
    return gather_rows(x, r0 - width, r0 + x.shape[2] + width, mesh, pad)


def out_rows(height: int, kernel: int, stride: int, padding: int,
             dilation: int) -> int:
    """Output rows of a conv over `height` rows."""
    return (height + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def conv_input(x: torch.Tensor, kernel: int, stride: int, padding: int,
               dilation: int = 1, pad: float = 0.0) -> torch.Tensor:
    """The rows of the row-sharded x that this rank's output rows of a
    conv (or pool) along H read, for the op with row padding 0: output
    rows [o0, o0 + ho) read rows [o0*stride - padding, (o0 + ho - 1) *
    stride - padding + dilation*(kernel - 1) + 1).  The global output
    must split as the input does (ho * stride == h)."""
    mesh = current()
    h = x.shape[2]
    total = out_rows(h * mesh.size, kernel, stride, padding, dilation)
    ho = total // mesh.size
    if total % mesh.size or ho * stride != h:
        raise ValueError(f"a conv of {h * mesh.size} rows (kernel {kernel}, "
                         f"stride {stride}, padding {padding}) does not "
                         f"split over {mesh.size} ranks")
    o0 = mesh.rank * ho
    lo = o0 * stride - padding
    hi = (o0 + ho - 1) * stride - padding + dilation * (kernel - 1) + 1
    return gather_rows(x, lo, hi, mesh, pad)


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
