"""Data parallel over NCCL, one rank per card, against one card.

    python -m s2r_tpu_torch.tools.profile_dist [--world 4]

On a host with `--world` cards, `--world` dividing 8 (tools/dist_check.py
spawns the ranks, LOCAL_RANK r on card r, the environment torchrun gives
them):

1. whether NCCL takes two ranks on one card (one all-reduce);
2. the output step at 256x512, global batch 2 * world, float32, 2 steps,
   dropout off, against one process on the whole batch on card 0: the
   losses, G's update per leaf, every rank's state bit-equal, the
   all-reduces a step;
3. the output step at bench.py's cell (512x1024 bf16) timed at a rank's
   batch of 8 (global 8 * world, weak scaling) and of 8 / world (global
   8, strong scaling), against one process at batch 8: ms/step (host
   clock around synchronized steps, median of 5 after 2 warm-up), peak
   memory, launches and all-reduces a step;
4. ``cli.train_adapt`` under ``torch.distributed.run`` at 512x512 bf16
   on --dataset synthetic --device-aug, two epochs, global batch
   8 * world against one process at batch 8: the epochs' images/s and
   the files of the run directory.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from s2r_tpu_torch.tools import dist_check as D


def _updates(snaps):
    before, after = snaps[0]["G"], snaps[-1]["G"]
    return {k: after[k].double() - before[k].double() for k in after
            if after[k].is_floating_point()
            and not k.endswith(("running_mean", "running_var"))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=4)
    args = parser.parse_args(argv)
    world = args.world
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    card0 = torch.device("cuda", 0)

    try:
        D.spawn({"tasks": [{"kind": "ping"}]}, 2, "cuda", backend="nccl",
                timeout=120)
        print("[1 nccl, two ranks on one card] the all-reduce ran",
              flush=True)
    except RuntimeError as e:
        err = [ln for ln in str(e).splitlines() if "Duplicate" in ln
               or "Error" in ln]
        print(f"[1 nccl, two ranks on one card] refused: {err[-2:]}",
              flush=True)

    check = dict(kind="steps", method="output_adapt", hw=[256, 512],
                 batch=2 * world, steps=2, precision="f32")
    weak = dict(kind="timing", method="output_adapt", hw=[512, 1024],
                batch=8 * world, precision="bf16", warmup=2, timed=5)
    strong = dict(weak, batch=8)
    t0 = time.perf_counter()
    ranks = D.spawn({"tasks": [check, weak, strong]}, world, "cuda",
                    backend="nccl", timeout=900, one_card=False)
    spawn_s = time.perf_counter() - t0
    ref = D.run_tasks({"tasks": [check, strong]}, card0)
    got = ranks[0][0]
    print(f"[2 numerics] {world} ranks (NCCL, a card each) against one "
          f"card, 512x256 global batch {2 * world} f32 ({spawn_s:.1f} s "
          "for all tasks): " + "; ".join(
              f"step {i} " + ", ".join(
                  f"{k} {got['metrics'][i][k]:.7g}/"
                  f"{ref[0]['metrics'][i][k]:.7g}"
                  for k in ("seg_loss", "adv_loss", "d_loss"))
              for i in range(2)), flush=True)
    gu, wu = _updates(got["snapshots"]), _updates(ref[0]["snapshots"])
    leaf = {k: float((gu[k] - wu[k]).norm() / wu[k].norm()) for k in wu
            if float(wu[k].norm())}
    print(f"[2 numerics] G update per leaf against one card: worst "
          f"{max(leaf.values()):.4g}, median "
          f"{statistics.median(leaf.values()):.4g}; ranks bit-equal "
          f"{all(r[i]['ranks_equal'] for r in ranks for i in range(3))}; "
          f"all-reduces a step {got['collectives_per_step']:.0f}",
          flush=True)
    one = statistics.median(ref[1]["ms"])
    for i, name, per in ((1, "weak", 8), (2, "strong", 8 / world)):
        ms = [statistics.median(r[i]["ms"]) for r in ranks]
        t = ranks[0][i]
        rate = 8 * world * 1e3 / max(ms) if name == "weak" \
            else 8 * 1e3 / max(ms)
        print(f"[3 {name}] 512x1024 bf16, {per:g} a rank (global "
              f"{int(per * world)}): ms/step a rank "
              + ", ".join(f"{m:.3f}" for m in ms)
              + " (rank 0's runs " + ", ".join(f"{v:.3f}" for v in t["ms"])
              + f"); {rate:.2f} source images/s against one card's "
              f"{8e3 / one:.2f} ({one:.3f} ms at batch 8, runs "
              + ", ".join(f"{v:.3f}" for v in ref[1]["ms"])
              + f"); peak {t['peak_gib']:.2f} GiB a rank; "
              f"{t['collectives_per_step']:.0f} all-reduces "
              f"({t['elements_per_step'] / 1e6:.3f}M elements) and BatchNorm "
              f"launches {dict((k, v) for k, v in t['launches_per_step'].items() if v)}"
              " a step", flush=True)
    del ranks, ref
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="s2r_profile_dist_")
    repo = D.REPO
    for nproc in (world, 1):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc-per-node", str(nproc), "--master-port",
               str(D._free_port()), "-m", "s2r_tpu_torch.cli.train_adapt",
               "--dataset", "synthetic", "--device-aug", "--crop-size",
               "512", "--base-size", "512", "--epochs", "2", "--precision",
               "bf16", "--workers", "4", "--batch-size", str(8 * nproc),
               "--run-root", os.path.join(root, f"w{nproc}")]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                           env=dict(os.environ, PYTHONPATH=repo),
                           timeout=900)
        rates = [float(v) for v in re.findall(r"\(([\d.]+) img/s\)",
                                              p.stdout)]
        files = sorted(f for _, _, fs in os.walk(os.path.join(
            root, f"w{nproc}")) for f in fs if not f.startswith("events"))
        print(f"[4 train_adapt] torch.distributed.run --nproc-per-node "
              f"{nproc}, global batch {8 * nproc}: exit {p.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; epoch images/s (each "
              f"rank's line) {rates}; files {files}", flush=True)
        if p.returncode:
            print(p.stderr[-4000:], flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
