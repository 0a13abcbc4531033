"""3x3 depthwise convolution (stride 1, zero padding = dilation), NHWC,
with its gradient.

The port of the TPU kernel ``s2r_tpu/ops/pallas/depthwise.py``
(``depthwise_conv3x3`` and its VJP).  ``depthwise_conv3x3`` (the forward,
and the VJP's ``dx`` on the flipped taps) and ``depthwise_dk`` (the VJP's
``dk``) launch the hand-written CUDA kernels of
``s2r_tpu_torch/csrc/depthwise.cu`` for CUDA tensors and take the plain
PyTorch versions only for CPU tensors.  There is no fallback: anything the
kernels do not take raises.  ``DepthwiseConv3x3`` is the autograd Function
that ties them together.

Both kernels are one tile sweep (the source says how): a block owns a
channel chunk, a tile of output columns, a run of rows of one row class
(rows of equal residue mod the dilation) and a stride of images, and
stages the rows it reads, with their column halo, through a ring in shared
memory by cp.async.  ``sweep_plan`` works the launch out here, on the host,
from the shape alone, and ``staged_rows`` / ``staged_cols`` / ``tap_col``
say which input rows and columns a block stages and where a thread reads
its taps, so that the tests check the decomposition on the CPU.

The forward launches once per run of whole images of fewer than 2^31
elements (``over_batch``); only a single image of 2^31 or more elements
raises.  dk offsets are 64-bit and it takes any batch in one launch (its
slab partials folded in its last block, or by a second kernel where there
are many).

MobileNetV2 runs its 14 stride-1 depthwise convs through here
(models/layers.py); the ``fill`` ring of the reference's padding quirk stays
outside, in the Conv2d identity, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from s2r_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "s2r_dw3x3_f32", torch.bfloat16: "s2r_dw3x3_bf16"}
_DK = {torch.float32: "s2r_dw3x3_dk_f32", torch.bfloat16: "s2r_dw3x3_dk_bf16"}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

# The kernels' limits (csrc/depthwise.cu).
MAX_THREADS = 256          # a block
MAX_AHEAD = 6              # rows staged ahead
MAX_CHUNKS = 1024          # dk arrival counters, one a channel chunk
MAX_SMEM = 227 * 1024      # shared memory a block on an H100
MAX_IMAGES_GRID = 65535    # grid.y
PLAN_FIELDS = 10           # int64s of a plan (csrc/depthwise.cu PlanField)
# Bytes a thread vector and columns a thread: the forward holds its nine
# taps and three rows of sums; dk's nine tap sums, shared by its columns,
# fit 64 registers (csrc/depthwise.cu).
VEC_BYTES = {"forward": 16, "dk": 8}
COLS = {"forward": 1, "dk": 2}


@dataclasses.dataclass(frozen=True)
class SweepTuning:
    """What a sweep plan is made from: bytes a channel chunk, threads a
    block, rows staged ahead, the blocks to aim for, the fewest output rows
    a run, and (dk) the most slab loads a thread of the last block may
    fold."""
    chunk_bytes: int
    threads: int
    ahead: int
    target_blocks: int
    min_rows: int
    fold_loads: int = 0


# The defaults, from timing candidate plans on an H100 (PERF.md): a whole
# pixel a chunk where it is at most 320 bytes, 128 threads a block on
# images of 8192 pixels or more and 64 on smaller ones; dk's slabs folded
# by its last block while that is at most 128 loads a thread, else by
# slab_fold.
FORWARD = SweepTuning(chunk_bytes=128, threads=128, ahead=4,
                      target_blocks=132 * 16, min_rows=2)
DK = SweepTuning(chunk_bytes=64, threads=128, ahead=2, target_blocks=132 * 4,
                 min_rows=4, fold_loads=128)


def default_tuning(kind: str, h: int, w: int, c: int,
                   itemsize: int) -> SweepTuning:
    """The tuning sweep_plan uses for a shape unless given one."""
    if kind == "dk":
        return DK
    return dataclasses.replace(
        FORWARD, chunk_bytes=256 if c * itemsize <= 320 else 128,
        threads=128 if h * w >= 8192 else 64)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """One launch of a depthwise sweep (csrc/depthwise.cu Sweep).

    vec channels a thread vector; a block is nvb vectors x tw // cols
    threads over a tile of tw columns (thread column tc owns columns tc,
    tc + tw // cols, ...) and walks `rows` output rows of one of `classes`
    row classes (class p holds rows p, p + d, ...), `runs` runs a class;
    grid.y = images_grid blocks stride over the images; `ahead` rows are
    staged before use.  For dk, `fused` says the last block of a chunk
    folds the `slabs` partials."""
    vec: int
    nvb: int
    tw: int
    cols: int
    rows: int
    runs: int
    classes: int
    images_grid: int
    ahead: int
    fused: bool
    smem: int
    # derived, for the wrapper and the tests
    nchunks: int
    ntiles: int
    span: int
    slabs: int

    @property
    def blocks(self) -> int:
        return self.nchunks * self.ntiles * self.classes * self.runs \
            * self.images_grid

    def fields(self) -> Tuple[int, ...]:
        """The int64 plan the C entries read (csrc/depthwise.cu PlanField)."""
        return (self.vec, self.nvb, self.tw, self.rows, self.runs,
                self.classes, self.images_grid, self.ahead, int(self.fused),
                self.smem)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _chunk_vectors(nv: int, most: int) -> int:
    """Vectors a channel chunk: the divisor of nv nearest `most` in [most/2,
    2 most] (no ragged chunk; the smaller on a tie), else min(nv, most)."""
    fits = [m for m in range(max(1, most // 2), min(nv, 2 * most) + 1)
            if nv % m == 0]
    if not fits:
        return min(nv, most)
    return min(fits, key=lambda m: (abs(m - most), m))


@functools.lru_cache(maxsize=4096)
def sweep_plan(kind: str, n: int, h: int, w: int, c: int, d: int,
               itemsize: int, aligned: bool,
               tuning: SweepTuning = None) -> SweepPlan:
    """The launch of the forward (kind 'forward') or dk ('dk') sweep on
    [n, h, w, c] at dilation d, elements of `itemsize` bytes; `aligned`:
    every pointer is on a VEC_BYTES[kind] boundary."""
    if kind not in VEC_BYTES:
        raise ValueError(f"sweep_plan: unknown kind {kind!r}")
    t = tuning or default_tuning(kind, h, w, c, itemsize)
    vec = VEC_BYTES[kind] // itemsize
    if not aligned or c % vec:
        vec = 1
    nv = c // vec
    nvb = _chunk_vectors(nv, max(1, t.chunk_bytes // (vec * itemsize)))
    nchunks = _cdiv(nv, nvb)
    cols = COLS[kind]
    ntiles = _cdiv(w, cols * max(1, t.threads // nvb))
    tw = cols * _cdiv(_cdiv(w, ntiles), cols)
    classes = min(d, h)
    seq = _cdiv(h, d)                      # rows of the longest class
    base = nchunks * ntiles * classes      # blocks a run and an image
    if base * n >= t.target_blocks:
        # enough blocks with whole classes: a block streams several images,
        # which pays the pipeline's fill once and keeps dk's partials few
        runs, images = 1, min(n, _cdiv(t.target_blocks, base))
    else:
        runs = max(1, min(_cdiv(t.target_blocks, base * n),
                          _cdiv(seq, t.min_rows)))
        images = n
    images = max(1, min(images, MAX_IMAGES_GRID))
    rows = _cdiv(seq, runs)
    runs = _cdiv(seq, rows)
    span = tw + 2 * min(d, tw)
    slots = t.ahead + 2
    piece = nvb * vec * itemsize           # bytes a staged column
    if kind == "forward":
        smem = slots * span * piece
        slabs, fused = 0, False
    else:
        smem = max(slots * (span + tw) * piece,
                   nvb * (tw // cols) * (9 * vec + 1) * 4)
        slabs = images * ntiles * classes * runs
        loads = _cdiv(9 * nvb * vec, nvb * (tw // cols)) * slabs
        fused = loads <= t.fold_loads and nchunks <= MAX_CHUNKS
    return SweepPlan(vec=vec, nvb=nvb, tw=tw, cols=cols, rows=rows, runs=runs,
                     classes=classes, images_grid=images, ahead=t.ahead,
                     fused=fused, smem=smem, nchunks=nchunks, ntiles=ntiles,
                     span=span, slabs=slabs)


def staged_rows(plan: SweepPlan, h: int, d: int, cls: int, run: int
                ) -> List[int]:
    """The input rows a block of class `cls`, run `run` stages, in order
    (-1: outside the image, staged as zeros): j0 - 1 .. j1 of the class,
    where the run's output rows are j0 .. j1 - 1 (empty past the class)."""
    nseq = _cdiv(h - cls, d)
    j0, j1 = run * plan.rows, min((run + 1) * plan.rows, nseq)
    if j0 >= j1:
        return []
    rows = [cls + j * d for j in range(j0 - 1, j1 + 1)]
    return [r if 0 <= r < h else -1 for r in rows]


def staged_cols(plan: SweepPlan, w: int, d: int, tile: int) -> List[int]:
    """The input columns of tile `tile`'s staged row, by staged column
    (-1: outside the image, zeros): [w0 - d, w0 + tw + d) when d <= tw,
    else the tw-wide segments at w0 - d, w0, w0 + d."""
    w0, tw = tile * plan.tw, plan.tw
    cols = []
    for sc in range(plan.span):
        j, tc = divmod(sc, tw)
        gc = w0 - d + sc if d <= tw else w0 + (j - 1) * d + tc
        cols.append(gc if 0 <= gc < w else -1)
    return cols


def tap_col(plan: SweepPlan, d: int, tc: int, dx: int) -> int:
    """The staged column that thread column tc reads for tap dx."""
    return tc + dx * min(d, plan.tw)


def depthwise_conv3x3_plain(x: torch.Tensor, k: torch.Tensor,
                            dilation: int = 1) -> torch.Tensor:
    """The same function as a grouped F.conv2d in float32 (float64 stays
    float64), cast back to x's dtype: x [N,H,W,C], k [3,3,C] -> [N,H,W,C]."""
    c = x.shape[-1]
    f = torch.promote_types(x.dtype, torch.float32)
    w = k.to(f).permute(2, 0, 1).unsqueeze(1)  # [C,1,3,3]
    y = F.conv2d(x.to(f).permute(0, 3, 1, 2), w, padding=dilation,
                 dilation=dilation, groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def depthwise_dk_plain(x: torch.Tensor, g: torch.Tensor,
                       dilation: int = 1) -> torch.Tensor:
    """The VJP's dk as nine shifted products summed in float32 (the JAX
    package's _dw_bwd; float64 stays float64): x, g [N,H,W,C] -> dk
    [3,3,C]."""
    d = int(dilation)
    h, w = x.shape[1], x.shape[2]
    f = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(f), (0, 0, d, d, d, d))
    g32 = g.to(f)
    return torch.stack([
        torch.stack([(xp[:, dy * d:dy * d + h, dx * d:dx * d + w] * g32)
                     .sum((0, 1, 2)) for dx in range(3)])
        for dy in range(3)])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library with its entries' types set, once."""
    lib = build.load("depthwise")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in _DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [p] * 3 + [i64] * 5 + [p, p]
        fn.restype = ctypes.c_int
    for name in _DK.values():
        fn = getattr(lib, name)
        fn.argtypes = [p] * 4 + [i64] * 5 + [p, p]
        fn.restype = ctypes.c_int
    lib.s2r_dw3x3_plan_fields.restype = ctypes.c_int
    fields = lib.s2r_dw3x3_plan_fields()
    if fields != PLAN_FIELDS:
        raise RuntimeError(f"depthwise: the library reads {fields} plan "
                           f"fields, the wrapper passes {PLAN_FIELDS}")
    return lib


@functools.lru_cache(maxsize=4096)
def _launch_args(kind: str, dtype: torch.dtype, n: int, h: int, w: int,
                 c: int, d: int, aligned: bool):
    """(the C entry, the plan, the address of its int64 fields, the fields),
    once a shape: a launch then costs the host no more than the call."""
    plan = sweep_plan(kind, n, h, w, c, d, _ITEMSIZE[dtype], aligned)
    fields = (ctypes.c_int64 * PLAN_FIELDS)(*plan.fields())
    fn = getattr(_lib(), (_DTYPES if kind == "forward" else _DK)[dtype])
    return fn, plan, ctypes.addressof(fields), fields


def _check_cuda(what: str, x: torch.Tensor, other: torch.Tensor) -> None:
    """Raise unless x and other can go to the kernels: one CUDA device, one
    of the kernels' types, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if x.dtype not in _DTYPES or other.dtype != x.dtype:
        raise TypeError(f"{what}: {x.dtype} and {other.dtype} must both be "
                        "float32 or both bfloat16")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: input is not on the current device")


def depthwise_conv3x3(x: torch.Tensor, k: torch.Tensor,
                      dilation: int = 1) -> torch.Tensor:
    """x [N,H,W,C] f32/bf16, k [3,3,C] in x's dtype -> [N,H,W,C] in x's dtype.

    Stride 1, zero padding = dilation, f32 accumulation.  Any C, H, W.
    """
    if x.dim() != 4 or k.shape != (3, 3, x.shape[-1]):
        raise ValueError(f"depthwise_conv3x3: x {tuple(x.shape)} must be "
                         f"[N,H,W,C] and k {tuple(k.shape)} [3,3,C]")
    if int(dilation) < 1:
        raise ValueError(f"depthwise_conv3x3: dilation {dilation} < 1")
    if x.device != k.device:
        raise ValueError("depthwise_conv3x3: x and k on different devices")
    if x.numel() == 0:  # no rows (an empty band): no launch
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.device.type == "cpu":
        return depthwise_conv3x3_plain(x, k, dilation)
    _check_cuda("depthwise_conv3x3", x, k)
    y = torch.empty_like(x)
    over_batch(x, k, y, int(dilation), _launch_dw3x3)
    return y


depthwise_conv3x3.launches = 0


def over_batch(x: torch.Tensor, k: torch.Tensor, y: torch.Tensor,
               dilation: int, launch, limit: int = build.INDEX_LIMIT) -> None:
    """Fill y from x by launch(x[a:b], k, y[a:b], dilation) over runs of
    whole images of fewer than `limit` elements each (images are
    independent, so the split changes nothing)."""
    if x.numel() < limit:
        launch(x, k, y, dilation)
        return
    for a, b in build.batch_chunks(x.shape[0], x.numel() // x.shape[0],
                                   limit):
        launch(x[a:b], k, y[a:b], dilation)


def _launch_dw3x3(x: torch.Tensor, k: torch.Tensor, y: torch.Tensor,
                  dilation: int) -> None:
    """One launch of the forward sweep on contiguous CUDA x, y."""
    n, h, w, c = x.shape
    xp, kp, yp = x.data_ptr(), k.data_ptr(), y.data_ptr()
    fn, _, plan, _ = _launch_args("forward", x.dtype, n, h, w, c, dilation,
                                  (xp | kp | yp) % VEC_BYTES["forward"] == 0)
    err = fn(xp, kp, yp, n, h, w, c, dilation, plan, build.stream(x))
    build.check(err, "depthwise_conv3x3")
    depthwise_conv3x3.launches += 1


def dk_scratch_floats(plan: SweepPlan, c: int) -> int:
    """Floats of the dk scratch a plan needs: its slab partials."""
    return plan.slabs * 9 * c


def depthwise_dk(x: torch.Tensor, g: torch.Tensor,
                 dilation: int = 1) -> torch.Tensor:
    """x, g [N,H,W,C] f32/bf16 of one type -> dk [3,3,C] float32, with
    dk[dy,dx,c] = sum over n,h,w of x[n, h+(dy-1)d, w+(dx-1)d, c] * g[n,h,w,c]
    (zero outside the image)."""
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"depthwise_dk: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be one [N,H,W,C] shape")
    if int(dilation) < 1:
        raise ValueError(f"depthwise_dk: dilation {dilation} < 1")
    if x.device != g.device:
        raise ValueError("depthwise_dk: x and g on different devices")
    n, h, w, c = x.shape
    if x.numel() == 0:  # no rows (an empty band): no launch
        return torch.zeros((3, 3, c), dtype=torch.promote_types(
            x.dtype, torch.float32), device=x.device)
    if x.device.type == "cpu":
        return depthwise_dk_plain(x, g, dilation)
    _check_cuda("depthwise_dk", x, g)
    dk = torch.empty((3, 3, c), dtype=torch.float32, device=x.device)
    d = int(dilation)
    xp, gp = x.data_ptr(), g.data_ptr()
    fn, plan, fields, _ = _launch_args("dk", x.dtype, n, h, w, c, d,
                                       (xp | gp) % VEC_BYTES["dk"] == 0)
    part = torch.empty((dk_scratch_floats(plan, c),), dtype=torch.float32,
                       device=x.device)
    err = fn(xp, gp, part.data_ptr(), dk.data_ptr(), n, h, w, c, d, fields,
             build.stream(x))
    build.check(err, "depthwise_dk")
    depthwise_dk.launches += 1
    return dk


depthwise_dk.launches = 0


class DepthwiseConv3x3(torch.autograd.Function):
    """depthwise_conv3x3 with its VJP (s2r_tpu/ops/pallas/depthwise.py
    _dw_bwd): dx is the same kernel on the cotangent with the taps flipped
    in both spatial axes, dk is depthwise_dk cast to k's type."""

    @staticmethod
    def forward(ctx, x, k, dilation: int):
        ctx.save_for_backward(x, k)
        ctx.dilation = int(dilation)
        return depthwise_conv3x3(x, k, dilation)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        d = ctx.dilation
        g = g.to(x.dtype).contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv3x3(g, k.flip((0, 1)).contiguous(), d)
        if ctx.needs_input_grad[1]:
            dk = depthwise_dk(x, g, d).to(k.dtype)
        return dx, dk, None
