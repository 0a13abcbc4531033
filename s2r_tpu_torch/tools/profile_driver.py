"""Where an epoch of the train_adapt driver goes, on one GPU: the parts
that chip_smoke.py does not time.

    python -m s2r_tpu_torch.tools.profile_driver [--dataset synthetic]
        [--route device|host|cache|native] [--crop 512] [--batch 8]
        [--workers 4 8] [--epochs 1]

Builds the driver's Trainer as ``python -m s2r_tpu_torch.cli.train_adapt``
does, in a temporary directory removed after: ``--dataset synthetic``
makes scenes on the host threads (route ``device``, --device-aug, by
default); ``--dataset gtav2cityscapes`` first writes full-size fixtures
(tools/fixtures.py: 64 GTA5-sized sources with labels and 64
Cityscapes-sized targets, so that an epoch has the synthetic driver's 8
steps of 8, 8 val pairs, 8 test frames) and reads them on the default host
path (route ``host``), with --device-aug (``device``), with --data-cache
(``cache``) or with --data-backend native (``native``: the native
pipeline's loaders, the worker count its thread count).  For each worker
count it times, by host clock around synchronized work:
- decode alone: the epoch's PNG frames decoded on that many threads (real
  data only);
- the loader alone (decode and the host transforms);
- the loader through the prefetch to the card and what the card finishes
  there (the augmentation, or the normalization);
- the steps alone, on the epoch's finished batches held on the card (no
  loader running);
- after `epochs` warm-up epochs, one epoch (Trainer.training: loader,
  feed, steps and one image-logging call) unprofiled, then one under
  torch.profiler: its wall time, the device's summed kernel time and the
  idle share (1 - device / wall).
Then one image-logging call and the validation loader alone.  Each beside
the card's name and power limit.  The step alone, each epoch's images/s and
validation ms/image are chip_smoke.py's (phases 5 and 7).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.profiler import ProfilerActivity, profile

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.data import datasets, imaging, native
from s2r_tpu_torch.parallel.feed import prefetch_to_device
from s2r_tpu_torch.tools import fixtures
from s2r_tpu_torch.train.trainer import Trainer


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _epoch_frames(loader, n):
    """(path, decode) of every frame the first n samples of a train loader
    read, a target per sample: the PIL route's decoders, or the native
    pipeline's on its route."""
    if hasattr(loader, "dataset"):
        ds = loader.dataset
        srcs, tgts, labels = ds.sources, ds.targets, ds.src_label_root
        rgb, label = imaging.load_rgb, datasets._load_label
    else:  # data/native_loader.py NativeTrainLoader
        srcs, tgts, labels = loader.src_imgs, loader.tgt_imgs, \
            loader.label_root
        rgb, label = ((lambda p: native.decode_png(p, 3)),
                      (lambda p: native.decode_png(p, 1)))
    out = []
    for i in range(n):
        out += [(srcs[i], rgb), (tgts[i % len(tgts)], rgb),
                (os.path.join(labels, os.path.basename(srcs[i])), label)]
    return out


def _set_workers(loader, w):
    if hasattr(loader, "num_workers"):
        loader.num_workers = w
    else:  # the native loader's thread pool
        loader.threads = w


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="synthetic",
                    choices=("synthetic", "gtav2cityscapes"))
    ap.add_argument("--route", choices=("device", "host", "cache", "native"),
                    help="device: --device-aug; host: the host transforms; "
                    "cache: --data-cache; native: --data-backend native "
                    "(gtav2cityscapes only; default: device for synthetic, "
                    "host for gtav2cityscapes)")
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--precision", default="bf16")
    a = ap.parse_args()
    real = a.dataset != "synthetic"
    route = a.route or ("host" if real else "device")
    if route == "native" and not real:
        ap.error("--route native reads PNGs: use --dataset gtav2cityscapes")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    root = tempfile.mkdtemp(prefix="s2r_profile_driver_")
    try:
        data = {}
        if real:
            s, files = _timed(lambda: fixtures.write_fixtures(
                os.path.join(root, "data"), n_gta=64, n_city=64))
            data = fixtures.roots(os.path.join(root, "data"))
            print(f"[fixtures] {len(files)} PNG files in {s:.3f} s")
            del files
        cfg = Config(dataset=a.dataset, device_aug=route == "device",
                     data_cache=route == "cache",
                     data_backend="native" if route == "native" else "pil",
                     crop_size=a.crop,
                     base_size=a.crop, batch_size=a.batch,
                     workers=a.workers[0], precision=a.precision,
                     epochs=a.epochs + 1, run_root=os.path.join(root, "run"),
                     **data)
        t = Trainer(cfg, method="output_adapt")
        n_img = len(t.train_loader) * a.batch
        print(f"[setup] {a.dataset}, route {route}, {a.crop}x{a.crop} batch "
              f"{a.batch} {a.precision}, {len(t.train_loader)} steps an "
              f"epoch ({smi})")

        def loader_only():
            for _ in t.train_loader:
                pass

        def feed_and_finish():
            out = None
            for i, b in enumerate(prefetch_to_device(t.train_loader,
                                                     t.device)):
                out = t._finish_batch(
                    {k: v for k, v in b.items() if torch.is_tensor(v)}, 0, i)
            return out

        batch, epoch = None, 0
        for w in a.workers:
            _set_workers(t.train_loader, w)
            if real:
                frames = _epoch_frames(t.train_loader, n_img)
                with ThreadPoolExecutor(w) as pool:
                    s, _ = _timed(lambda: list(pool.map(
                        lambda f: f[1](f[0]), frames)))
                print(f"[decode] {w} workers: {len(frames)} PNG frames in "
                      f"{s:.3f} s, {n_img / s:.2f} samples/s ({smi})")
            s, _ = _timed(loader_only)
            print(f"[host] {w} workers: loader alone {s:.3f} s an epoch, "
                  f"{n_img / s:.2f} images/s ({smi})")
            s, batch = _timed(feed_and_finish)
            print(f"[feed] {w} workers: loader + prefetch + finish on the "
                  f"card {s:.3f} s an epoch, {n_img / s:.2f} images/s "
                  f"({smi})")
            held = [t._finish_batch({k: v for k, v in b.items()
                                     if torch.is_tensor(v)}, 0, i)
                    for i, b in enumerate(prefetch_to_device(t.train_loader,
                                                             t.device))]

            def steps_only():
                for b in held:
                    t.state, _ = t.train_step(t.state, b)

            s, _ = _timed(steps_only)
            print(f"[step] {len(held)} steps alone on batches held on the "
                  f"card: {s:.3f} s, {n_img / s:.2f} images/s ({smi})")
            del held
            for _ in range(a.epochs):
                t.training(epoch)
                epoch += 1
            s, _ = _timed(lambda: t.training(epoch))
            epoch += 1
            print(f"[epoch] {w} workers: {s:.3f} s, {n_img / s:.2f} "
                  f"images/s ({smi})")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall, _ = _timed(lambda: t.training(epoch))
            epoch += 1
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            dev = sum(e.self_device_time_total for e in kernels) / 1e6
            print(f"[epoch] {w} workers, profiled: wall {wall:.3f} s "
                  f"({n_img / wall:.2f} images/s), device {dev:.3f} s, idle "
                  f"share {max(0.0, 1 - dev / wall):.3f}, "
                  f"{sum(e.count for e in kernels)} device kernels ({smi})")
        logs = [_timed(lambda: t._log_train_images(batch, 0))[0]
                for _ in range(3)]
        print(f"[log] one image-logging call: "
              f"{', '.join(f'{1e3 * r:.3f}' for r in logs)} ms ({smi})")

        def val_loader_only():
            for _ in t.val_loader:
                pass

        s, _ = _timed(val_loader_only)
        print(f"[val] loader alone: "
              f"{1e3 * s / (len(t.val_loader) * a.batch):.3f} ms/image "
              f"({smi})")
        t.saver.wait()
        t.writer.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
