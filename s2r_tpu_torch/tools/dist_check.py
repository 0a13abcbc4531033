"""Data-parallel training against one process: the train steps and the
Trainer at a world of W processes, each stepping its share of every global
batch, against one process stepping the whole batch.

    python -m s2r_tpu_torch.tools.dist_check --world 4 --device cpu
    python -m s2r_tpu_torch.tools.dist_check --world 4 --spatial 2 \
        --device cpu        # 2 data rows x 2 bands of rows
    python -m s2r_tpu_torch.tools.dist_check --world 2 --device cuda \\
        --backend gloo      # two ranks on one card

Each rank is a child process of this one (``spawn``), started with the
environment torchrun would give it (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR=localhost, MASTER_PORT) and initializing its group itself
(core/distributed.py ``maybe_initialize``); on one card every rank gets
LOCAL_RANK 0.  A spec (JSON) names the tasks each rank runs:

- ``steps``: build a method (train/setup.py ``build_method`` with
  n_devices=W), dropout off, BatchNorm statistics and affine perturbed
  (tools/step_conditioning.py), or a state loaded from a file; optionally
  every leaf, statistic and optimizer buffer in float64
  (``float64_leaves``: the float32-free reference of the CPU tests); then
  take `steps` steps on seeded global batches (``global_batch``; labels
  with ignored rows spread unevenly over the samples), each rank on
  ``b[rank::W]``, or under ``spatial`` S its data row's samples and its
  band of their rows (``remat`` and ``spatial`` are the Config's; under
  ``pad_to``, masked batch padding of the global batch to pad_to, each
  data row the real samples of its contiguous shard).  Results: the
  metrics of each step, whether every rank
  holds the same state bit for bit (``ranks_equal``, by an all-reduce of
  the maximum and the minimum), the collectives a step, and on rank 0 the
  state before the first step and after each;
- ``timing``: ms/step (host clock around synchronized steps), each
  BatchNorm entry's launches and the collectives a step (all-reduces
  over every group, and the halo all-gathers with the elements a rank
  sent), and peak device memory;
- ``ping``: one all-reduce of a one-element tensor, and one broadcast
  of each rank's number (rank 0's arrives everywhere);
- ``eval``: the method's eval step on a seeded global batch
  (``eval_batch``), BatchNorm statistics perturbed, each rank on its
  share (under ``eval_spatial``, ``--eval-spatial-shard``: the whole
  batch and its band of the world's rows): the loss share, the confusion
  matrix share, the labels (uint8), the collectives and gathers; with
  ``ties`` (one process) also where the logits' top two lie within 1e-4
  of the larger's magnitude (or of 1), where float32 may flip a label;
- ``trainer``: a Trainer (``cli.train_adapt``'s) on ``--dataset
  synthetic``: the validation confusion matrix of the initial state, then
  ``fit`` for one epoch of `train_steps` steps (rank 0 alone writes the
  run directory); ``spatial`` and ``eval_spatial`` set
  ``--spatial-shard`` and ``--eval-spatial-shard``, ``num_devices``
  ``--num-devices`` (default: the mesh's size).

A spec with ``subworld`` ({"batch", "num_devices", "spatial"}) runs the
tasks on the ranks the JAX package's rule takes of the W (core/mesh.py
``pick_num_devices``), ranks 0..n-1, and idles the others: an idle rank
runs no task (a ``trainer`` task builds its Trainer, which goes idle,
and calls ``fit``), makes the groups every rank must make, and reports
``{"idle": True, "collectives": the collectives it issued after set-up,
"end_barriers": the end-of-run barriers it passed, "peak_bytes": its
peak device memory, "kernel_launches": the kernels it launched}``.
Every rank counts its collectives after set-up
(``collectives_after_setup`` beside its results).

``run_tasks`` runs the same tasks in this process at W = 1: the
reference.  chip_smoke.py phase 10b and tests/test_torch_port_distributed.py
drive this module.  Gloo all-reduces CUDA tensors through the host: a time
taken so measures the host staging, not NCCL across cards.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.core import mesh as mesh_mod
from s2r_tpu_torch.core.distributed import maybe_initialize
from s2r_tpu_torch.core.mesh import Layout, Mesh, make_mesh, state_tensors
from s2r_tpu_torch.models.layers import set_dropout
from s2r_tpu_torch.tools.step_conditioning import perturb_batchnorm
from s2r_tpu_torch.train import setup
from s2r_tpu_torch.train.setup import build_method

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the BatchNorm entries (ops/kernels/batchnorm.py) whose launches a step
# the timing task reports
BN_ENTRIES = ("batch_norm_stats", "batch_norm_apply", "batch_norm_grad_sums",
              "batch_norm_dx", "batch_norm_sums", "batch_norm_finish_apply",
              "batch_norm_grad_sums_local", "batch_norm_grad_finish")


def global_batch(method: str, hw, n: int, seed: int) -> Dict[str, np.ndarray]:
    """A seeded global batch of `n` samples at hw (int or (h, w)): NHWC
    float32 images, int64 labels with the top 2*i rows of sample i ignored
    (255), so the ranks' shares count different numbers of pixels."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 19, (n, h, w)).astype(np.int64)
    for i in range(n):
        label[i, :2 * i] = 255
    src = rs.randn(n, h, w, 3).astype(np.float32)
    tgt = rs.randn(n, h, w, 3).astype(np.float32)
    if method == "source_only":
        return {"image": src, "label": label}
    return {"src_image": src, "tgt_image": tgt, "src_label": label}


def shard(batch: Dict[str, np.ndarray], layout: Layout,
          pad_to: Optional[int] = None) -> Dict:
    """This rank's share of a global batch: the loader's b[row::rows] of
    its data row (b[rank::world] without a spatial axis), and its band of
    their rows (core/mesh.py ``Layout.band``, with 'height').  With
    `pad_to`, the real samples of its shard of the padded global batch
    (pad_to / rows a shard, JAX's layout: the pad samples on the last
    rows), possibly none."""
    data = layout.data
    if pad_to:
        per = pad_to // data.size
        cut = slice(data.rank * per, (data.rank + 1) * per)
    else:
        cut = slice(data.rank, None, data.size)
    return layout.band({k: torch.as_tensor(v[cut])
                        for k, v in batch.items()})


def _to_float64(state) -> None:
    """Every floating leaf, statistic and optimizer buffer of `state` in
    float64 (in place)."""
    state.G.double()
    state.D.double()
    state.opt_state = {
        name: {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
               else v for k, v in s.items()}
        for name, s in state.opt_state.items()}


def _config(spec: Dict) -> Config:
    hw = spec["hw"] if isinstance(spec["hw"], int) else max(spec["hw"])
    return Config(precision=spec.get("precision", "f32"),
                  backbone=spec.get("backbone", "mobilenet"),
                  logits_dtype=spec.get("logits_dtype", "f32"),
                  loss_type=spec.get("loss_type", "ce"),
                  crop_size=hw, base_size=hw, batch_size=spec["batch"],
                  seed=spec.get("seed", 1), remat=spec.get("remat", False),
                  spatial_shard=spec.get("spatial", 1),
                  eval_spatial_shard=spec.get("eval_spatial", False))


def build(spec: Dict, device, mesh: Mesh):
    """(method, state) of a steps or timing task, as the module docstring
    says."""
    step_pad_to = setup._step_pad_to
    if spec.get("pad_to"):  # off a TPU the rule pads nothing: set it
        setup._step_pad_to = lambda cfg, n: spec["pad_to"]
    try:
        m = build_method(_config(spec), iters_per_epoch=10,
                         method=spec["method"], device=device,
                         n_devices=mesh.size)
    finally:
        setup._step_pad_to = step_pad_to
    set_dropout(m.deeplab, False)
    set_dropout(m.aux_model, False)
    state = m.init_state()
    if spec.get("init"):
        saved = torch.load(spec["init"], map_location="cpu",
                           weights_only=False)
        state.G.load_state_dict(saved["G"], strict=True)
        state.D.load_state_dict(saved["D"], strict=True)
        state.opt_state = {name: {k: v.to(state.G.device)
                                  if torch.is_tensor(v) else v
                                  for k, v in s.items()}
                           for name, s in saved["opt_state"].items()}
        state.step = int(saved["step"])
    else:
        perturb_batchnorm(m.deeplab, 1, affine_seed=2)
        perturb_batchnorm(m.aux_model, 3, affine_seed=4)
    if spec.get("float64_leaves"):
        _to_float64(state)
    return m, state


def ranks_equal(mesh: Mesh, tensors: List[torch.Tensor]) -> bool:
    """Whether every rank holds the same `tensors` bit for bit (float64
    holds each float32, float64 and counter exactly): the all-reduced
    maximum equals the all-reduced minimum."""
    if mesh.size == 1:
        return True
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    top = mesh.all_reduce_(flat.clone(), op="max")
    low = -mesh.all_reduce_(-flat, op="max")
    return bool(torch.equal(top, low))


def _snapshot(state) -> Dict:
    return {net: {k: v.detach().to("cpu", copy=True)
                  for k, v in getattr(state, net).state_dict().items()}
            for net in ("G", "D")}


def _gathers(layout: Layout):
    """(all-gathers, elements sent) over the layout's groups so far."""
    return (sum(m.gathers for m in layout.meshes),
            sum(m.gathered for m in layout.meshes))


def run_steps(spec: Dict, device, mesh: Mesh) -> Dict:
    m, state = build(spec, device, mesh)
    metrics, snapshots = [], []
    mesh, layout = m.mesh, m.layout  # the method's: they count
    keep = mesh.rank == 0 and spec.get("snapshots", True)
    if keep:
        snapshots.append(_snapshot(state))
    calls, world_calls, gathers = layout.calls, mesh.calls, _gathers(layout)
    for i in range(spec["steps"]):
        batch = global_batch(spec["method"], spec["hw"], spec["batch"],
                             spec.get("data_seed", 7) + i)
        state, met = m.step_fn(state, shard(batch, layout,
                                            spec.get("pad_to")))
        metrics.append({k: float(v) for k, v in met.items()})
        if keep:
            snapshots.append(_snapshot(state))
    n = max(spec["steps"], 1)
    return {"metrics": metrics, "snapshots": snapshots,
            "collectives_per_step": (layout.calls - calls) / n,
            "world_collectives_per_step": (mesh.calls - world_calls) / n,
            "gathers_per_step": (_gathers(layout)[0] - gathers[0]) / n,
            "ranks_equal": ranks_equal(mesh, state_tensors(state))}


def _bn_counts() -> Dict[str, int]:
    from s2r_tpu_torch.ops.kernels import batchnorm as bn
    return {k: getattr(bn, k).launches for k in BN_ENTRIES}


def run_timing(spec: Dict, device, mesh: Mesh) -> Dict:
    """Steps timed: `warmup`, then `timed` steps, each ended by a
    synchronize on the card (host clock)."""
    m, state = build(spec, device, mesh)
    mesh, layout = m.mesh, m.layout
    card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    batch = shard(global_batch(spec["method"], spec["hw"], spec["batch"],
                               spec.get("data_seed", 7)), layout,
                  spec.get("pad_to"))
    batch = {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in batch.items()}
    for _ in range(spec.get("warmup", 2)):
        state, met = m.step_fn(state, batch)
    sync()
    if card:
        torch.cuda.reset_peak_memory_stats()
    before, calls, elements = _bn_counts(), layout.calls, sum(
        g.elements for g in layout.meshes)
    gathers = _gathers(layout)
    times = []
    for _ in range(spec.get("timed", 5)):
        t0 = time.perf_counter()
        state, met = m.step_fn(state, batch)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    n = len(times)
    after, gathered = _bn_counts(), _gathers(layout)
    return {"ms": times,
            "launches_per_step": {k: (after[k] - before[k]) / n
                                  for k in BN_ENTRIES},
            "collectives_per_step": (layout.calls - calls) / n,
            "elements_per_step": (sum(g.elements for g in layout.meshes)
                                  - elements) / n,
            "gathers_per_step": (gathered[0] - gathers[0]) / n,
            "halo_elements_per_step": (gathered[1] - gathers[1]) / n,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if card else None),
            "losses": {k: float(v) for k, v in met.items()},
            "ranks_equal": ranks_equal(mesh, state_tensors(state))}


def eval_batch(hw, n: int, seed: int) -> Dict[str, np.ndarray]:
    """A seeded validation batch: NHWC float32 images and int64 labels in
    [0, 19) with the top row of each sample ignored."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 19, (n, h, w)).astype(np.int64)
    label[:, :1] = 255
    return {"image": rs.randn(n, h, w, 3).astype(np.float32),
            "label": label}


def run_eval(spec: Dict, device, mesh: Mesh) -> Dict:
    m, _ = build(spec, device, mesh)
    layout = m.layout
    eval_rows = spec.get("eval_spatial", False)
    batch = {k: torch.as_tensor(v, device=device) for k, v in eval_batch(
        spec["hw"], spec["batch"], spec.get("data_seed", 7)).items()}
    if not eval_rows:  # the data row's samples; else the whole batch
        batch = {k: v[layout.data.rank::layout.data.size]
                 for k, v in batch.items()}
    batch = layout.band(batch, eval_rows)
    calls, gathers = layout.calls, _gathers(layout)
    loss, cm, pred = m.eval_step(batch["image"], batch["label"],
                                 batch.get("height"))
    out = {"loss": float(loss), "confusion": cm.cpu(),
           "pred": pred.to(torch.uint8).cpu(),
           "collectives": layout.calls - calls,
           "gathers": _gathers(layout)[0] - gathers[0]}
    if spec.get("ties"):
        if layout.world.size > 1:
            raise ValueError("eval ties: one process only")
        with torch.no_grad():
            logits, _ = m.deeplab.eval()(batch["image"].permute(0, 3, 1, 2))
            top = logits.topk(2, dim=1).values
            out["ties"] = (top[:, 0] - top[:, 1] <= 1e-4 * top[:, 0].abs()
                           .clamp(min=1.0)).cpu()
    return out


def run_trainer(spec: Dict, device, mesh) -> Dict:
    """The trainer task (the module docstring); on an idle rank the idle
    Trainer's ``fit``, and None."""
    from s2r_tpu_torch.train.trainer import Trainer

    cfg = Config(dataset="synthetic", precision=spec.get("precision", "f32"),
                 crop_size=spec["hw"], base_size=spec["hw"],
                 batch_size=spec["batch"], epochs=1, workers=1,
                 run_root=spec["run_root"], async_save=False,
                 num_devices=spec.get("num_devices", mesh.size
                                      if mesh.size > 1 else None),
                 spatial_shard=spec.get("spatial", 1),
                 eval_spatial_shard=spec.get("eval_spatial", False),
                 device_aug=spec.get("device_aug", False))
    trainer = Trainer(cfg, method="output_adapt", device=device)
    if trainer.idle:
        trainer.fit()
        return None
    if spec.get("train_steps"):  # a shorter epoch of the synthetic set
        trainer.train_loader.dataset.length = spec["train_steps"] * \
            cfg.batch_size
    trainer.validation(0)
    cm = trainer.evaluator.confusion_matrix
    means, training = [], trainer.training
    trainer.training = lambda epoch: means.append(training(epoch)) or \
        means[-1]
    trainer.fit()
    return {"confusion": cm, "best_pred": trainer.best_pred,
            "train_means": means,
            "miou": trainer.evaluator.Mean_Intersection_over_Union()[0],
            "experiment_dir": trainer.saver.experiment_dir,
            "ranks_equal": ranks_equal(mesh, state_tensors(trainer.state))}


def run_ping(spec: Dict, device, mesh: Mesh) -> Dict:
    """One all-reduce of a one-element tensor: the sum of the ranks; one
    broadcast of each rank's number plus one: rank 0's, 1."""
    t = torch.ones(1, device=device)
    b = torch.full((1,), float(mesh.rank + 1), device=device)
    mesh.broadcast_([b])
    return {"sum": float(mesh.all_reduce_(t)[0]), "broadcast": float(b[0])}


TASKS = {"steps": run_steps, "timing": run_timing, "trainer": run_trainer,
         "ping": run_ping, "eval": run_eval}


def kernel_wrappers() -> List:
    """The wrappers of the port's hand-written kernels, each counting its
    launches (``launches``)."""
    from s2r_tpu_torch.ops.kernels import (batchnorm, depthwise, disc_conv,
                                           requant)
    return [depthwise.depthwise_conv3x3, requant.requant_s32_to_s8,
            depthwise.depthwise_dk, disc_conv.disc_conv1,
            *[getattr(batchnorm, name) for name in BN_ENTRIES]]


def run_tasks(spec: Dict, device, mesh: Optional[Mesh] = None) -> List[Dict]:
    """Each task of `spec` on this process (its rank of `mesh`; one process
    when None), each result with the kernels' launches in the task
    ('kernel_launches': the counts set to 0 just before it)."""
    mesh = mesh or Mesh()
    out = []
    for task in spec["tasks"]:
        wrappers = kernel_wrappers()
        for fn in wrappers:
            fn.launches = 0
        result = TASKS[task["kind"]](task, device, mesh)
        result["kernel_launches"] = {fn.__name__: fn.launches
                                     for fn in wrappers}
        out.append(result)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """`world` child processes running a spec, one rank each (``start``);
    ``results()`` waits for them and returns their results by rank."""

    def __init__(self, spec: Dict, world: int, device: str,
                 backend: Optional[str], timeout: float, threads: int,
                 one_card: bool = True):
        self.timeout = timeout
        self.tmp = tempfile.TemporaryDirectory(prefix="s2r_dist_")
        spec_path = os.path.join(self.tmp.name, "spec.json")
        with open(spec_path, "w") as f:
            json.dump({**spec, "device": device, "backend": backend,
                       "threads": threads}, f)
        port = _free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK="0" if one_card else str(rank),
                       MASTER_ADDR="localhost",
                       MASTER_PORT=str(port),
                       PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            if device == "cpu":
                env["S2R_PLATFORM"] = "cpu"
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "s2r_tpu_torch.tools.dist_check",
                 "--child", spec_path, "--out", self.tmp.name], env=env,
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))

    def results(self) -> List[List[Dict]]:
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=self.timeout))
            for rank, (p, (out, err)) in enumerate(zip(self.procs, outs)):
                if p.returncode != 0:
                    raise RuntimeError(f"dist_check rank {rank} exited "
                                       f"{p.returncode}:\n{out[-2000:]}\n"
                                       f"{err[-4000:]}")
            return [torch.load(os.path.join(self.tmp.name, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(len(self.procs))]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self.tmp.cleanup()


def start(spec: Dict, world: int, device: str = "cpu",
          backend: Optional[str] = None, timeout: float = 600,
          threads: int = 1, one_card: bool = True) -> Ranks:
    """Start `spec` on `world` child processes, one rank each, and return
    at once.  On the card every rank sees device 0 with `one_card`
    (LOCAL_RANK 0: ranks share one card under gloo), else rank r card r
    (LOCAL_RANK r, torchrun's layout)."""
    return Ranks(spec, world, device, backend, timeout, threads, one_card)


def spawn(spec: Dict, world: int, device: str = "cpu",
          backend: Optional[str] = None, timeout: float = 600,
          threads: int = 1, one_card: bool = True) -> List[List[Dict]]:
    """``start`` and wait: the results by rank."""
    return start(spec, world, device, backend, timeout, threads,
                 one_card).results()


# torch.distributed's collectives, each counted by count_collectives
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "all_to_all", "all_to_all_single",
               "barrier", "broadcast", "broadcast_object_list", "gather",
               "irecv", "isend", "monitored_barrier", "recv", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "scatter", "send")


def count_collectives() -> Dict[str, int]:
    """Count every collective this process issues from now on, by name
    ('end' for core/mesh.py ``end_of_run``'s barriers): torch.distributed's
    functions wrapped in place (the port calls them through the module)."""
    counts: Dict[str, int] = {}
    end_groups = [g for _, g in mesh_mod._SUBWORLDS.values()]

    def wrap(name, fn):
        def counted(*a, **k):
            key = "end" if name == "barrier" and any(
                k.get("group") is g for g in end_groups) else name
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, **k)
        return counted

    for name in COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, wrap(name, getattr(dist, name)))
    return counts


def _idle(spec: Dict, mesh: mesh_mod.IdleRank, device, counts) -> List[Dict]:
    """An idle rank's part in each task: the groups every rank makes; a
    trainer task's Trainer, idle, and its ``fit`` (one end barrier)."""
    out = []
    for task in spec["tasks"]:
        if task["kind"] == "trainer":
            run_trainer(task, device, mesh)
        else:
            mesh_mod.make_layout(mesh, task.get("spatial", 1))
        out.append({"idle": True})
    card = torch.device(device).type == "cuda"
    report = {"idle": True,
              "collectives": sum(v for k, v in counts.items()
                                 if k != "end"),
              "end_barriers": counts.get("end", 0),
              "peak_bytes": torch.cuda.max_memory_reserved() if card
              else 0,
              "kernel_launches": {fn.__name__: fn.launches
                                  for fn in kernel_wrappers()}}
    return [dict(o, **report) for o in out]


def _child(spec_path: str, out_dir: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 1))
    # float32 convs and products in float32 (no TF32), as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize(spec.get("backend"))
    sub = spec.get("subworld")
    n = None if sub is None else mesh_mod.pick_num_devices(
        sub["batch"], sub.get("num_devices"), sub.get("spatial", 1))
    mesh = make_mesh(n)
    counts = count_collectives()  # set-up (the sub-world's group) is done
    device = ("cpu" if spec["device"] == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    try:
        if isinstance(mesh, mesh_mod.IdleRank):
            results = _idle(spec, mesh, device, counts)
        else:
            results = run_tasks(spec, device, mesh)
            for r in results:
                r["collectives_after_setup"] = dict(counts)
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
        if not isinstance(mesh, mesh_mod.IdleRank):
            mesh.barrier()
        mesh_mod.end_of_run(n)
    finally:
        dist.destroy_process_group()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float64 (0 when both are 0)."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den else num


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--child", type=str, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--out", type=str, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--device", type=str, default="cpu",
                        choices=["cpu", "cuda"])
    parser.add_argument("--backend", type=str, default=None,
                        choices=["gloo", "nccl"])
    parser.add_argument("--card-per-rank", action="store_true",
                        help="rank r on card r (default: every rank on "
                             "card 0)")
    parser.add_argument("--hw", type=int, default=64)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--method", type=str, default="output_adapt",
                        choices=["output_adapt", "feature_adapt",
                                 "source_only"])
    parser.add_argument("--precision", type=str, default="f64",
                        choices=["f64", "f32", "bf16"])
    parser.add_argument("--spatial", type=int, default=1,
                        help="--spatial-shard: bands of rows a sample")
    args = parser.parse_args(argv)
    if args.child:
        _child(args.child, args.out)
        return None
    task = {"kind": "steps", "method": args.method, "hw": args.hw,
            "batch": args.batch, "steps": args.steps,
            "precision": args.precision,
            "float64_leaves": args.precision == "f64",
            "spatial": args.spatial}
    spec = {"tasks": [task]}
    device = "cpu" if args.device == "cpu" else torch.device("cuda", 0)
    ranks = spawn(spec, args.world, args.device, args.backend,
                  one_card=not args.card_per_rank)
    ref = run_tasks({"tasks": [dict(task, spatial=1)]}, device)[0]
    got = ranks[0][0]
    for i, (a, b) in enumerate(zip(got["metrics"], ref["metrics"])):
        print(f"step {i}: " + ", ".join(
            f"{k} {a[k]:.9g} / {b[k]:.9g}" for k in a))
    for net in ("G", "D"):
        after, want = got["snapshots"][-1][net], ref["snapshots"][-1][net]
        worst = max(((rel_l2(after[k], want[k]), k) for k in want
                     if want[k].is_floating_point()), default=(0.0, None))
        print(f"{net}: worst leaf {worst[1]} rel L2 {worst[0]:.3g}")
    print(f"ranks equal: {all(r[0]['ranks_equal'] for r in ranks)}; "
          f"collectives a step {got['collectives_per_step']:.0f}, halo "
          f"gathers {got['gathers_per_step']:.0f}")
    return ranks, ref


if __name__ == "__main__":
    main()
