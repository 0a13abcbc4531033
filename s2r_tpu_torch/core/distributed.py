"""Process-group set-up for data-parallel training (s2r_tpu/core/distributed.py).

The JAX package scales past one device with a device mesh: one jitted step
runs SPMD over every device, and its process group comes from JAX's
distributed runtime.  The port runs one process per GPU, launched by
torchrun, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` in each process's environment:

    torchrun --nproc-per-node 4 -m s2r_tpu_torch.cli.train_adapt ...

``maybe_initialize`` sets up ``torch.distributed`` from that environment
(NCCL for the card, gloo for ``S2R_PLATFORM=cpu``) and binds the process
to ``cuda:LOCAL_RANK``.  Each process feeds its strided share of every
global batch (data/loader.py): ranks agree on the epoch's permutation and
take disjoint slices ``rank::world`` of each batch (``local_shard``), or
under ``--spatial-shard`` their data row's slice (``process_shares``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch.distributed as dist

from s2r_tpu_torch.core.device import platform_from_env, rank_device


def maybe_initialize(backend: Optional[str] = None) -> bool:
    """Initialize the process group from torchrun's environment; True when
    a group of more than one process is up.

    Nothing happens without ``WORLD_SIZE`` in the environment (a plain
    single-process run), or when the caller has initialized a group
    already.  `backend` defaults to NCCL on the card and gloo on the CPU
    (``S2R_PLATFORM=cpu``); on the card the process is bound to
    ``cuda:LOCAL_RANK`` first, and a machine without that device raises:
    a rank never falls back to the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ["WORLD_SIZE"])
    cpu = platform_from_env() == "cpu"
    if not cpu:
        rank_device(int(os.environ.get("LOCAL_RANK", "0")))
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return world > 1


def process_info() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_shares(spatial: int = 1, eval_rows: bool = False,
                   n_devices: Optional[int] = None
                   ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((index, count) of a train loader's share of every global batch,
    the same of an eval loader's), over the step's ranks: the world, or
    the sub-world of the first `n_devices` ranks (core/mesh.py
    ``make_mesh``; a rank past it loads nothing).  Without a spatial axis
    both are (rank, ranks).  Under ``--spatial-shard S`` the S ranks of a
    data row load the same samples, the share of their row (rank // S,
    ranks // S), and each keeps its band of the rows; the eval loaders
    follow the JAX package (s2r_tpu/parallel/feed.py:30,
    s2r_tpu/core/mesh.py:106-122): the data row's share, or with
    ``--eval-spatial-shard`` the whole batch, every rank keeping its band
    of the step's rows."""
    rank, world = process_info()
    if n_devices is not None:
        if rank >= n_devices:
            raise ValueError(f"rank {rank} idles: the step takes ranks "
                             f"0-{n_devices - 1}")
        world = int(n_devices)
    spatial = max(1, int(spatial))
    train = (rank // spatial, max(world // spatial, 1))
    return train, ((0, 1) if eval_rows else train)


def local_shard(index_range: int, process_id: int,
                process_count: int) -> List[int]:
    """Strided per-process index assignment for input sharding."""
    return list(range(process_id, index_range, process_count))


def require_single_process(what: str) -> None:
    """Raise for an entry point that runs on one device, as the JAX
    package's do (s2r_tpu/cli/_eval_common.py:61, export.py:132), when it
    is launched in a group of more than one process."""
    world = process_info()[1]
    if world == 1:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(f"s2r_tpu_torch: {what} runs on one device; it "
                           f"was launched as one of {world} processes "
                           "(run it without torchrun)")
