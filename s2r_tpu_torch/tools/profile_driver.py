"""Where an epoch of the train_adapt driver goes, on one GPU: the parts
that chip_smoke.py does not time.

    python -m s2r_tpu_torch.tools.profile_driver [--crop 512] [--batch 8]
        [--workers 4] [--epochs 1]

Builds the driver's Trainer as ``python -m s2r_tpu_torch.cli.train_adapt
--dataset synthetic --device-aug`` does (in a temporary run root, removed
after) and times, by host clock around synchronized work:
- the loader alone (making the synthetic scenes on the host threads);
- the loader through the prefetch to the card and the augmentation there;
- one image-logging call (an eval forward, the copy back, three PNGs);
- after `epochs` warm-up epochs, one epoch (Trainer.training) under
  torch.profiler: its wall time, the device's summed kernel time and the
  idle share (1 - device / wall);
- the validation loader alone.
Each beside the card's name and power limit.  The step alone, each
epoch's images/s and validation ms/image are chip_smoke.py's (phase 5).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.parallel.feed import prefetch_to_device
from s2r_tpu_torch.train.trainer import Trainer


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--precision", default="bf16")
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    root = tempfile.mkdtemp(prefix="s2r_profile_driver_")
    try:
        cfg = Config(dataset="synthetic", device_aug=True, crop_size=a.crop,
                     base_size=a.crop, batch_size=a.batch, workers=a.workers,
                     precision=a.precision, epochs=a.epochs + 1,
                     run_root=root)
        t = Trainer(cfg, method="output_adapt")
        n_img = len(t.train_loader) * a.batch
        print(f"[setup] {a.crop}x{a.crop} batch {a.batch} {a.precision}, "
              f"{len(t.train_loader)} steps an epoch, {a.workers} workers")

        def loader_only():
            for _ in t.train_loader:
                pass

        def feed_and_aug():
            out = None
            for i, b in enumerate(prefetch_to_device(t.train_loader,
                                                     t.device)):
                out = t._finish_batch(
                    {k: v for k, v in b.items() if torch.is_tensor(v)}, 0, i)
            return out

        s, _ = _timed(loader_only)
        print(f"[host] loader alone: {s:.3f} s an epoch, "
              f"{n_img / s:.2f} images/s")
        s, batch = _timed(feed_and_aug)
        print(f"[feed] loader + prefetch + augmentation: {s:.3f} s an "
              f"epoch, {n_img / s:.2f} images/s")
        logs = [_timed(lambda: t._log_train_images(batch, 0))[0]
                for _ in range(3)]
        print(f"[log] one image-logging call: "
              f"{', '.join(f'{1e3 * r:.3f}' for r in logs)} ms")
        for e in range(a.epochs):
            t.training(e)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = _timed(lambda: t.training(a.epochs))
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in kernels) / 1e6
        print(f"[epoch] profiled: wall {wall:.3f} s, device {dev:.3f} s, "
              f"idle share {max(0.0, 1 - dev / wall):.3f}, "
              f"{sum(e.count for e in kernels)} device kernels")

        def val_loader_only():
            for _ in t.val_loader:
                pass

        s, _ = _timed(val_loader_only)
        print(f"[val] loader alone: "
              f"{1e3 * s / (len(t.val_loader) * a.batch):.3f} ms/image")
        t.saver.wait()
        t.writer.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
