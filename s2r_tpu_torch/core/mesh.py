"""The data-parallel world of one process per device (s2r_tpu/core/mesh.py).

The JAX package jits one step over a device mesh: the batch dimension is
sharded over the 'data' axis, and every global reduction of the traced
program (gradient means, BatchNorm statistics, loss normalizers) becomes a
cross-device psum.  The port runs one process per GPU and makes those
reductions itself, through a ``Mesh`` (over the default process group, or
over a subgroup of it):

- ``all_reduce_`` sums (or maxes) one tensor over the ranks in place: the
  BatchNorm sums (models/layers.py), the loss normalizers and metrics
  (train/losses.py), the batch-axis softmax (train/steps.py);
- ``all_reduce_flat`` sums a list of tensors in one flat buffer: a step's
  gradients;
- ``all_gather`` hands every rank each rank's tensor, as the bytes it
  holds (no arithmetic, so any dtype on any backend): the halo exchanges
  of row-sharded layers (ops/halo.py);
- ``broadcast_`` copies rank 0's tensors to every rank: the initial or
  resumed state;
- ``barrier``.

Every helper is the identity at one process and then makes no collective
call, so a single-device run takes exactly the path it took before.
``calls`` and ``elements`` count what the all-reduces and broadcasts
moved, ``gathers`` and ``gathered`` the all-gathers (elements this rank
sent).

``--spatial-shard S`` (s2r_tpu/core/mesh.py:26-50, ``make_mesh(spatial=
S)``): a 2-D ('data', 'space') ``Layout`` of the world, rank r at data row
r // S and space column r % S.  The S ranks of a data row load the same
samples and each holds a contiguous band of their image rows; the
'space' group of a row exchanges halos (ops/halo.py) and sums ASPP's
pool, the 'data' group of a column (the ranks holding the same rows of
different samples) takes the batch-axis softmax, and the world stays the
group of the gradients, BatchNorm and the loss normalizers.

The band rule (``band_rows``, ``band_bounds``): an image of H rows over S
ranks, u the path's largest stride, is cut into bands of h =
ceil(H / (S*u)) * u rows; rank s holds rows [s*h, min((s+1)*h, H)).
Only the last band or bands are short, and a band may be empty, so any
H runs on any S, as GSPMD runs it by padding the last shard.  Every
activation at stride k holds the rows [s*h/k, ...) of its own global
height, which follows its layer's arithmetic (ops/halo.py).

The devices JAX idles (``pick_num_devices``, s2r_tpu/train/trainer.py:
40-80): where the batch does not divide the world (or ``--num-devices``
asks for fewer), the step takes the first n ranks, as JAX takes the
first n devices.  ``make_mesh(n)`` gives ranks 0..n-1 a ``Mesh`` over a
group of their own (the sub-world, which ``make_layout`` lays out and
whose ranks are their world ranks) and the others an ``IdleRank``.  An
idle rank builds no model, loads no data and joins no collective of the
run; torch makes it take part in every ``new_group`` (each rank of the
world calls them in the same order) and the driver's end meets it in
one barrier of the world (``end_of_run``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from s2r_tpu_torch.core.distributed import process_info


class Mesh:
    """`size` processes, this one `rank` of them, over `group` (a
    torch.distributed group; None: the default one, the world)."""

    def __init__(self, size: int = 1, rank: int = 0, group=None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a mesh of {size}")
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.calls = 0      # all-reduces and broadcasts issued
        self.elements = 0   # elements all-reduced or broadcast
        self.gathers = 0    # all-gathers issued
        self.gathered = 0   # elements this rank sent in them

    def __repr__(self) -> str:
        return f"Mesh(size={self.size}, rank={self.rank})"

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.elements += t.numel()

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum ('sum') or maximum ('max') of `t` over the ranks, in place
        (t must be contiguous); `t` itself at one process."""
        if self.size == 1:
            return t
        if not t.is_contiguous():
            raise ValueError("Mesh.all_reduce_: the tensor must be "
                             "contiguous")
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        self._count(t)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (one shape and dtype on every rank), by rank;
        [t] at one process.  The bytes travel as uint8, so no backend's
        list of reduction types limits the dtype (gloo has no bfloat16
        all-gather) and the values arrive bit for bit."""
        if self.size == 1:
            return [t]
        t = t.contiguous()
        if t.dim() == 0:
            t = t.reshape(1)
        bits = t.view(torch.uint8)
        out = [torch.empty_like(bits) for _ in range(self.size)]
        dist.all_gather(out, bits, group=self.group)
        self.gathers += 1
        self.gathered += t.numel()
        return [o.view(t.dtype) for o in out]

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """The sums over the ranks of `tensors` (one dtype, one device), by
        one all-reduce of their concatenation; new tensors, shaped as
        given.  At one process the tensors themselves."""
        tensors = list(tensors)
        if self.size == 1 or not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat)
        return [v.view_as(t) for v, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite `tensors` with rank 0's, one broadcast a (dtype,
        device) group."""
        if self.size == 1:
            return
        groups = {}
        for t in tensors:
            groups.setdefault((t.dtype, t.device), []).append(t)
        src = 0 if self.group is None else dist.get_global_rank(
            self.group, 0)
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src, group=self.group)
            self._count(flat)
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


# num_devices -> (the sub-world's group, the world's group of the one
# barrier at the end) where the step takes fewer ranks than the world, made
# once: every rank of the world calls new_group for each, in the same order
_SUBWORLDS: Dict[int, tuple] = {}
# a week: an idle rank waits out the whole run at the end barrier
_END_TIMEOUT = datetime.timedelta(days=7)


class IdleRank:
    """A rank that the step's sub-world (ranks 0..size-1) leaves out
    (``make_mesh``): it builds nothing, joins no collective of the run and
    meets the world only where torch demands it, in every ``new_group``
    and in ``end_of_run``."""

    def __init__(self, size: int, rank: int, world: int):
        self.size, self.rank, self.world = int(size), int(rank), int(world)

    def __repr__(self) -> str:
        return (f"IdleRank(rank={self.rank} of {self.world}; the step takes "
                f"0-{self.size - 1})")


def _subworld(n: int) -> tuple:
    if n not in _SUBWORLDS:
        group = dist.new_group(list(range(n))) if n > 1 else None
        end = dist.new_group(backend="gloo", timeout=_END_TIMEOUT)
        _SUBWORLDS[n] = (group, end)
    return _SUBWORLDS[n]


def make_mesh(num_devices: Optional[int] = None):
    """The mesh of the step's ranks (one process without a group): the
    world, or with `num_devices` n below it the sub-world of ranks
    0..n-1, as the JAX package takes ``devices[:n]``
    (s2r_tpu/core/mesh.py:43-44).  Ranks n.. get an ``IdleRank``.  At n ==
    world no group is made, so a run that takes every rank takes the
    default group."""
    rank, world = process_info()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"s2r_tpu_torch: {num_devices} devices asked for, but this "
            f"process is one of {world}: data-parallel training runs one "
            f"process per device (torchrun --nproc-per-node {num_devices})")
    if n == world:
        return Mesh(world, rank)
    group, _ = _subworld(n)
    if rank >= n:
        return IdleRank(n, rank, world)
    return Mesh(n, rank, group)


def end_of_run(num_devices: Optional[int] = None) -> None:
    """The one barrier of the whole world at a driver's end where the
    step's sub-world of `num_devices` ranks leaves ranks idle: every rank
    passes it once, the idle ones having waited there since set-up.  It
    runs over a gloo group of its own whose deadline is a week, so no
    backend's default timeout ends an idle rank's wait, and no card is
    touched.  Nothing without idle ranks."""
    n = process_info()[1] if num_devices is None else int(num_devices)
    if n in _SUBWORLDS:
        dist.barrier(group=_SUBWORLDS[n][1])


def _say(msg: str) -> None:
    if process_info()[0] == 0:
        print(msg, flush=True)


def pick_num_devices(batch_size: int, requested: Optional[int] = None,
                     spatial: int = 1, log: bool = True) -> int:
    """The ranks the step takes, by the JAX package's rule
    (s2r_tpu/train/trainer.py:40-80), a torchrun world of W ranks on one
    node playing JAX's one process with W devices: without a spatial axis
    the largest d <= min(W, `requested` or W) dividing the batch; with
    ``--spatial-shard S`` > 1, of the available min(W, requested) (which S
    must divide), S times that rule's count of data rows.  The ranks
    past it idle (``make_mesh``), and rank 0 says so.  A world spanning
    nodes (``LOCAL_WORLD_SIZE`` below W) plays JAX's multi-host: the
    batch must divide W, which is taken whatever `requested` says, and a
    spatial axis raises NotImplementedError."""
    world = process_info()[1]
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if spatial > 1:
        if local != world:
            raise NotImplementedError(
                f"--spatial-shard is one node's: this world of {world} "
                f"processes spans nodes of {local}")
        avail = min(world, requested) if requested else world
        if avail % spatial:
            raise ValueError(f"--spatial-shard {spatial} must divide the "
                             f"device count ({avail})")
        dp = pick_num_devices(batch_size, avail // spatial, log=False)
        if log and dp * spatial < avail:
            _say(f"[s2r_tpu_torch] using {dp * spatial}/{avail} devices "
                 f"({dp} data x {spatial} spatial): batch_size {batch_size} "
                 f"is not divisible by {avail // spatial} rows (consider "
                 "--batch-pad auto or a divisible batch)")
        return dp * spatial
    if local != world:
        if batch_size % world:
            raise ValueError(
                f"multi-host runs need global batch_size ({batch_size}) "
                f"divisible by total devices ({world})")
        return world
    limit = min(world, requested or world)
    for d in range(limit, 0, -1):
        if batch_size % d == 0:
            if d < limit and log:
                _say(f"[s2r_tpu_torch] using {d}/{limit} devices: batch_size "
                     f"{batch_size} is not divisible by {limit} (consider "
                     "--batch-pad auto or a divisible batch)")
            return d
    return 1


def band_rows(height: int, spatial: int, unit: int = 1) -> int:
    """The rows of a full band of an image of `height` rows over `spatial`
    ranks, `unit` the path's largest stride: ceil(height / (spatial *
    unit)) * unit (the module docstring's band rule)."""
    step = int(spatial) * int(unit)
    return -(-int(height) // step) * int(unit)


def band_bounds(height: int, band: int, rank: int) -> Tuple[int, int]:
    """Rows [r0, r1) of rank `rank`'s band of `band` rows in an image of
    `height`: short or empty past the image's end."""
    return min(rank * band, height), min((rank + 1) * band, height)


@dataclasses.dataclass
class Layout:
    """The 2-D ('data', 'space') layout of `world`: `spatial` columns, rank
    r at data row r // spatial and column r % spatial (the module
    docstring).  `space` is the mesh of this rank's data row (its rank:
    the column), `data` that of its column (its rank: the data row); at
    spatial 1, `space` is one process and `data` the world itself; at
    spatial == world, `space` is the world and `data` one process.
    `unit` is the largest stride of the method's path, the band rule's u
    (train/setup.py sets it from the model)."""
    world: Mesh
    space: Mesh
    data: Mesh
    spatial: int = 1
    unit: int = 1

    @property
    def meshes(self) -> List[Mesh]:
        """The distinct meshes of more than one process, each once."""
        out = []
        for m in (self.world, self.space, self.data):
            if m.size > 1 and all(m is not o for o in out):
                out.append(m)
        return out

    @property
    def calls(self) -> int:
        """All-reduces and broadcasts issued over every group."""
        return sum(m.calls for m in self.meshes)

    def rows_mesh(self, eval_rows: bool = False) -> Mesh:
        """The mesh whose ranks split a sample's rows: the space group, or
        the world with `eval_rows`."""
        return self.world if eval_rows else self.space

    def band(self, arrays: Dict, eval_rows: bool = False) -> Dict:
        """This rank's band of rows of every [N, H, ...] tensor of `arrays`
        (NHWC images, [N, H, W] labels; others pass), by the band rule at
        `unit` over the ranks of ``rows_mesh``, and 'height': the global
        H, which the steps read (ops/halo.py ``row_shard``)."""
        mesh = self.rows_mesh(eval_rows)
        if mesh.size == 1:
            return arrays
        out, heights = {}, set()
        for k, v in arrays.items():
            if torch.is_tensor(v) and v.dim() >= 3:
                heights.add(int(v.shape[1]))
                r0, r1 = band_bounds(v.shape[1], band_rows(
                    v.shape[1], mesh.size, self.unit), mesh.rank)
                v = v[:, r0:r1]
            out[k] = v
        if len(heights) > 1:
            raise ValueError(f"band: tensors of {sorted(heights)} rows")
        if heights:
            out["height"] = heights.pop()
        return out


# (world size, spatial) -> the torch.distributed groups of every row and
# column, made once: every rank must call new_group for each group, in
# the same order
_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}


def _subgroups(world: int, spatial: int) -> Tuple[list, list]:
    key = (world, spatial)
    if key not in _GROUPS:
        rows = [dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                for d in range(world // spatial)]
        cols = [dist.new_group(list(range(c, world, spatial)))
                for c in range(spatial)]
        _GROUPS[key] = (rows, cols)
    return _GROUPS[key]


def make_layout(world, spatial: int = 1) -> Optional[Layout]:
    """The 2-D layout of `world` at `spatial` columns (Layout).  Subgroups
    are made only where a group of more than one process is neither the
    world nor one process, so spatial 1 and spatial == world make none.
    An ``IdleRank`` makes the same subgroups of the step's sub-world, as
    torch's new_group demands of every rank, and gets None."""
    spatial = max(1, int(spatial))
    if world.size % spatial:
        raise ValueError(f"--spatial-shard {spatial} must divide the "
                         f"device count ({world.size})")
    if isinstance(world, IdleRank):
        if 1 < spatial < world.size:
            _subgroups(world.size, spatial)
        return None
    if spatial == 1:
        return Layout(world, Mesh(), world, 1)
    row, col = divmod(world.rank, spatial)
    if spatial == world.size:
        return Layout(world, world, Mesh(), spatial)
    rows, cols = _subgroups(world.size, spatial)
    return Layout(world, Mesh(spatial, col, rows[row]),
                  Mesh(world.size // spatial, row, cols[col]), spatial)


def rank_seed(seed: int, mesh: Mesh, step: int = 0) -> int:
    """The seed of a rank's dropout generator: `seed` itself at one process
    (the single-device run's); at more, one seed for each (seed, rank,
    step), so no two ranks draw the same masks (`step`: the step a
    resumed run starts at)."""
    if mesh.size == 1:
        return seed
    return (seed, mesh.rank, step).__hash__() & 0x7FFFFFFFFFFFFFFF


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor a TrainState holds (train/state.py): the modules'
    parameters and buffers, and the optimizer states' buffers, in a fixed
    order."""
    out = [t.data for m in (state.G, state.D)
           for t in list(m.parameters()) + list(m.buffers())]
    for name in sorted(state.opt_state):
        opt = state.opt_state[name]
        out += [opt[k] for k in sorted(opt) if torch.is_tensor(opt[k])]
    return out
