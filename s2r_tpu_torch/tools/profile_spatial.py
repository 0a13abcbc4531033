"""--spatial-shard over NCCL, one rank per card, against one card.

    python -m s2r_tpu_torch.tools.profile_spatial [--world 4]
    python -m s2r_tpu_torch.tools.profile_spatial --device cpu --hw 64 128 \
        --world 2 --batch 2 --resnet-batches 1 2   # a CPU rehearsal (gloo)

On a host with `--world` cards (tools/dist_check.py spawns the ranks,
LOCAL_RANK r on card r, the environment torchrun gives them), the output
step at 2048x1024 bf16 (bench.py's full-resolution crop), global batch
`--batch`, each rank holding every sample and a band of the rows:

1. MobileNetV2 on one card, then at --spatial-shard 2 (2 ranks) and at
   --spatial-shard `--world` (`--world` ranks): ms/step (host clock
   around synchronized steps, median of `--timed` after 1 warm-up), peak
   memory a rank, all-reduces and halo gathers a step and the halo
   elements a rank sends;
2. ResNet-101 at --spatial-shard 2 at `--resnet-batches` global batches
   (one card holds 6, PERF.md section 5): peak memory a rank at each, and
   the largest batch whose peak the linear fit through them keeps under
   the card's memory.

Prints the card's name and power limit first, then one line a
measurement.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

from s2r_tpu_torch.tools import dist_check as D


def _line(name: str, results) -> dict:
    """A summary of one timing task's results, one per rank."""
    r = results[0]
    return {"name": name, "ranks": len(results),
            "ms": [statistics.median(x["ms"]) for x in results],
            "peak_gib": [x["peak_gib"] for x in results],
            "collectives_per_step": r["collectives_per_step"],
            "gathers_per_step": r.get("gathers_per_step", 0),
            "halo_elements_per_step": r.get("halo_elements_per_step", 0),
            "ranks_equal": all(x["ranks_equal"] for x in results)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--hw", type=int, nargs=2, default=[1024, 2048])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--timed", type=int, default=3)
    parser.add_argument("--resnet-batches", type=int, nargs="*",
                        default=[6, 10])
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = args.device == "cuda"
    if card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(smi.splitlines()[0], flush=True)
    backend = "nccl" if card else "gloo"
    timing = dict(kind="timing", method="output_adapt", hw=args.hw,
                  batch=args.batch, precision="bf16" if card else "f32",
                  warmup=1, timed=args.timed)
    one = D.run_tasks({"tasks": [timing]},
                      torch.device("cuda", 0) if card else "cpu")[0]
    print(_line("mobilenet one card", [one]), flush=True)
    torch.cuda.empty_cache()
    for s in sorted({2, args.world}):
        res = D.spawn({"tasks": [dict(timing, spatial=s)]}, s, args.device,
                      backend=backend, timeout=900, one_card=False)
        print(_line(f"mobilenet --spatial-shard {s}", [r[0] for r in res]),
              flush=True)
    peaks = []
    for b in args.resnet_batches:
        res = D.spawn({"tasks": [dict(timing, backbone="resnet101", batch=b,
                                      spatial=2)]}, 2, args.device,
                      backend=backend, timeout=900, one_card=False)
        line = _line(f"resnet101 --spatial-shard 2 batch {b}",
                     [r[0] for r in res])
        peaks.append((b, max(p or 0 for p in line["peak_gib"])))
        print(line, flush=True)
    if card and len(peaks) >= 2:
        (b0, p0), (b1, p1) = peaks[0], peaks[-1]
        per = (p1 - p0) / (b1 - b0)
        total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        largest = b0 + int((total - p0) // per) if per > 0 else None
        print({"name": "resnet101 --spatial-shard 2 largest batch (linear "
                       "fit of the peaks)", "gib_per_sample": per,
               "card_gib": total, "largest_batch": largest}, flush=True)


if __name__ == "__main__":
    main()
