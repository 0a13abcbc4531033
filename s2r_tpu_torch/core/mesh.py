"""The data-parallel world of one process per device (s2r_tpu/core/mesh.py).

The JAX package jits one step over a device mesh: the batch dimension is
sharded over the 'data' axis, and every global reduction of the traced
program (gradient means, BatchNorm statistics, loss normalizers) becomes a
cross-device psum.  The port runs one process per GPU and makes those
reductions itself, through a ``Mesh``:

- ``all_reduce_`` sums (or maxes) one tensor over the ranks in place: the
  BatchNorm sums (models/layers.py), the loss normalizers and metrics
  (train/losses.py), the batch-axis softmax (train/steps.py);
- ``all_reduce_flat`` sums a list of tensors in one flat buffer: a step's
  gradients;
- ``broadcast_`` copies rank 0's tensors to every rank: the initial or
  resumed state;
- ``barrier``.

Every helper is the identity at one process and then makes no collective
call, so a single-device run takes exactly the path it took before.
``calls`` and ``elements`` count what the collectives moved.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from s2r_tpu_torch.core.distributed import process_info


class Mesh:
    """`size` processes, this one `rank`, over the default process group."""

    def __init__(self, size: int = 1, rank: int = 0):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a mesh of {size}")
        self.size = int(size)
        self.rank = int(rank)
        self.calls = 0      # collectives issued
        self.elements = 0   # elements all-reduced or broadcast

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
                        else dist.ReduceOp.MAX)
        self._count(t)
        return t

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
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            self._count(flat)
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The mesh of the running process group (one process without one).
    `num_devices`, when given, must be its size."""
    rank, world = process_info()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"s2r_tpu_torch: {num_devices} devices asked for, but this "
            f"process is one of {world}: data-parallel training runs one "
            f"process per device (torchrun --nproc-per-node {num_devices})")
    return Mesh(world, rank)


def pick_num_devices(batch_size: int, requested: Optional[int] = None) -> int:
    """The data-parallel width: the process group's size, which
    ``--num-devices`` must equal when given, and which must divide the
    global batch (the JAX package's multi-host rule,
    s2r_tpu/train/trainer.py:66-71)."""
    world = make_mesh(requested).size
    if batch_size % world:
        raise ValueError(f"global batch_size ({batch_size}) must be "
                         f"divisible by the number of processes ({world})")
    return world


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
