"""Where a cli.infer sweep's time goes once its pipeline is full, on one GPU.

    python -m s2r_tpu_torch.tools.profile_infer

chip_smoke.py's phase 8d sweeps 24 frames in three batches of 8, so its
ms/image holds the pipeline's fill (batch 0 waits for its decode) and its
drain (the saves still queued after the last serving call), and its
steady state after batch 0 covers two batches.  This tool sweeps the same
24 frames (tools/fixtures.py: 16 Cityscapes-sized, 8 GTA5-sized that the
host resizes) once as they are and once linked 5 times under new names
(120 frames, 15 batches), through the user's path: a seeded, untrained
output_adapt state saved as a checkpoint, ``cli.export --format servable
--serve-shape 8 1024 2048 --serve-input rgb8``, exact and with
``--serve-quant decoder-int8`` (calibrated on 4 synthetic val batches),
then ``cli.infer``.  For each servable and sweep it prints, by host clock
and unprofiled: cli.infer's ms/image including host IO and its steady
state after batch 0; the serving call's ms/image after batch 0 (host to
device, the forward, device to host); and each stage's ms/image of wall
(decode+resize summed over its threads over their number, the serving
calls, the saves summed over their 2 threads over 2), beside the card's
name and power limit.  Everything is written in a temporary directory
removed after.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import torch

from s2r_tpu_torch.tools import fixtures

FRAMES = dict(n_gta=8, n_city=16, n_val=0, n_test=0)  # chip_smoke.py's 8d
SHAPE = (8, 1024, 2048)
REPEAT = 5  # copies of the 24 frames in the long sweep
SEED = 1


def _link_copies(paths, dst: str, repeat: int) -> None:
    """`repeat` hard links of each frame in `dst`, in the same order."""
    os.makedirs(dst)
    for r in range(repeat):
        for i, p in enumerate(paths):
            os.link(p, os.path.join(dst, f"{r:02d}_{i:03d}_"
                                         f"{os.path.basename(p)}"))


def _report(mode: str, sweep: str, res: dict, workers: int) -> None:
    n, sec = res["images"], res["seconds"]
    later = res["device_batches"][1:]
    dev_later = 1e3 * sum(later) / max(1, len(later) * SHAPE[0])
    per = {"decode": 1e3 * sec["decode"] / n / workers,
           "device": 1e3 * sec["device"] / n,
           "save": 1e3 * sec["save"] / n / 2}
    print(f"[{mode} {sweep}] {n} frames, {len(res['device_batches'])} "
          f"batches: {res['ms_per_image']:.3f} ms/image including host IO, "
          f"steady-state {res['steady_ms_per_image']:.3f} after batch 0 "
          f"(wall {res['wall']:.3f} s); serving call {dev_later:.3f} "
          f"ms/image after batch 0; per frame on one thread: decode+resize "
          f"{1e3 * sec['decode'] / n:.3f} ms ({workers} threads), save "
          f"{1e3 * sec['save'] / n:.3f} ms (2 threads); ms/image of wall "
          "by stage " + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
          + f": paced by {max(per, key=per.get)}")


def main():
    from s2r_tpu_torch.cli import export, infer
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.core.device import device_from_env
    from s2r_tpu_torch.io.checkpoint import save_checkpoint
    from s2r_tpu_torch.train.setup import build_method

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    root = tempfile.mkdtemp(prefix="s2r_profile_infer_")
    try:
        run = ["--dataset", "synthetic", "--device-aug", "--crop-size",
               "512", "--base-size", "512", "--batch-size", "8",
               "--precision", "bf16", "--workers", "4", "--run-root",
               os.path.join(root, "run")]
        torch.manual_seed(SEED)
        m = build_method(Config(dataset="synthetic", precision="bf16",
                                seed=SEED), iters_per_epoch=1,
                         method="output_adapt", device=device_from_env())
        ckpt = os.path.join(root, "seeded.ckpt")
        save_checkpoint(ckpt, m.init_state(), 0, 0.0)
        del m
        servables = {}
        for mode, extra in (("exact", []),
                            ("int8", ["--serve-quant", "decoder-int8"])):
            servables[mode] = os.path.join(root, f"{mode}.s2rt")
            export.main(run + [
                "--resume", ckpt, "--format", "servable", "--serve-shape",
                *map(str, SHAPE), "--serve-input", "rgb8", "--out",
                servables[mode]] + extra)

        short = os.path.join(root, "frames")
        fixtures.write_fixtures(short, **FRAMES)
        shutil.rmtree(os.path.join(short, "gta5", "labels"))
        long_ = os.path.join(root, "frames_long")
        _link_copies(infer.list_frames(short), long_, REPEAT)
        workers = os.cpu_count() or 1
        for mode, path in servables.items():
            for sweep, frames in (("24", short),
                                  (f"24x{REPEAT}", long_)):
                out = os.path.join(root, "out")
                res = infer.main(["--servable", path, "--images", frames,
                                  "--out-dir", out])
                shutil.rmtree(out)
                _report(mode, sweep, res, workers)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
