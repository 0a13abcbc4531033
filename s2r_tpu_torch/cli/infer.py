"""Run a servable over a directory of frames: a servable in, PNGs out
(s2r_tpu/cli/infer.py).

The deployment half of ``cli.export --format servable``: no checkpoint and
no training configuration, only the artifact (io/serving.py) and the
frames.

    python -m s2r_tpu_torch.cli.infer --servable model.s2rt \\
        --images data/frames/ --out-dir result/

Outputs are cli.test's: ``<stem>_labelId.png`` (Cityscapes labelIds) and
``<stem>_color.png`` a frame, at 1280x640 (cli/_eval_common.py
``_save_prediction``).  Frames are decoded with data/imaging.py
``load_rgb`` and resized to the artifact's H x W with its
``resize_bilinear`` (both Pillow's bytes); the last, partial batch is
padded with its last frame and the padding discarded.  ``--host-backend``
is accepted for the JAX package's flag surface: its three values all take
data/imaging.py, which gives the pixels of the JAX package's PIL and
native paths alike.  ``.jpg`` and ``.jpeg`` frames (told from PNGs by
their bytes) take data/imaging.py ``decode_jpeg``, Pillow's decode bit
for bit; the kinds of JPEG it refuses raise (ROADMAP A.4).

The host loop is pipelined as the JAX package's: frames are decoded and
resized on a thread pool, the next ``--prefetch`` batches are assembled
while the device runs the current one, and PNGs are written on a pool of
two threads, at most 4 batches of saves in flight.  Runs on the card;
``S2R_PLATFORM=cpu`` selects the CPU.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from s2r_tpu_torch.data import imaging
from s2r_tpu_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD

FRAME_EXTS = (".png", ".jpg", ".jpeg")


def list_frames(root: str):
    """Frame paths under `root` (recursive, each directory's files
    sorted); raises for none."""
    paths = []
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in sorted(files)
                  if f.lower().endswith(FRAME_EXTS)]
    if not paths:
        raise FileNotFoundError(f"no frames under {root}")
    return paths


def decode_frame(path: str, h: int, w: int, input_kind: str) -> np.ndarray:
    """A frame as the servable takes it: uint8 RGB [h, w, 3], or the
    eval-transform float32 (x/255 - mean) / std for 'normalized'."""
    img = imaging.load_rgb(path)
    if img.shape[:2] != (h, w):
        img = imaging.resize_bilinear(img, (w, h))
    if input_kind == "rgb8":
        return img
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return ((img.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)


class _Clock:
    """Seconds summed over threads, by stage."""

    def __init__(self):
        self.lock = threading.Lock()
        self.s: Dict[str, float] = {"decode": 0.0, "save": 0.0}

    def timed(self, stage, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        dt = time.perf_counter() - t0
        with self.lock:
            self.s[stage] += dt
        return out


def main(argv=None, keep_predictions: bool = False) -> Dict:
    """Sweep the frames; returns {'images', 'ms_per_image' (including
    host IO), 'steady_ms_per_image' (after batch 0, or None), 'seconds':
    {'decode', 'device', 'save'} summed over their threads,
    'device_batches' (each serving call's seconds: host to device, the
    forward, device to host), 'wall'} and, with `keep_predictions`,
    'predictions': {path: [H, W] int32}."""
    parser = argparse.ArgumentParser(
        description="sweep a directory with an s2r_tpu_torch servable")
    parser.add_argument("--servable", type=str, required=True)
    parser.add_argument("--images", type=str, required=True,
                        help="directory (recursive) of .png/.jpg frames")
    parser.add_argument("--out-dir", type=str, default="result",
                        dest="out_dir")
    parser.add_argument("--dataset", type=str, default="cityscapes",
                        help="palette for the color PNGs")
    parser.add_argument("--workers", type=int, default=None,
                        help="decode threads (default: cpu count)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="batches decoded ahead of the device")
    parser.add_argument("--host-backend", type=str, default="auto",
                        choices=["auto", "native", "pil"],
                        help="accepted for the JAX package's flags: all "
                             "three decode with data/imaging.py")
    args = parser.parse_args(argv)

    from s2r_tpu_torch.cli._eval_common import _save_prediction
    from s2r_tpu_torch.core.device import device_from_env
    from s2r_tpu_torch.core.distributed import require_single_process
    from s2r_tpu_torch.io.serving import load_servable

    require_single_process("cli.infer")
    paths = list_frames(args.images)
    serve = load_servable(args.servable, device_from_env())
    meta = serve.meta
    n, h, w, _ = meta["input_shape"]
    input_kind, output_kind = meta["input"], meta["output"]
    print(f"servable: {meta.get('backbone')} {h}x{w} batch {n}, "
          f"input={input_kind}, output={output_kind}, decoder=imaging")
    batches = [paths[i:i + n] for i in range(0, len(paths), n)]
    workers = args.workers or os.cpu_count() or 1
    clock = _Clock()
    kept: Dict[str, np.ndarray] = {}
    device_batches = []  # seconds of each batch's serving call

    frame_pool = ThreadPoolExecutor(workers)
    batch_pool = ThreadPoolExecutor(max(1, args.prefetch))
    save_pool = ThreadPoolExecutor(2)

    def decode_one(path):
        return clock.timed("decode", decode_frame, path, h, w, input_kind)

    def assemble(chunk):
        batch = np.stack(list(frame_pool.map(decode_one, chunk)))
        if len(chunk) < n:  # pad the tail batch; outputs sliced below
            pad = np.repeat(batch[-1:], n - len(chunk), axis=0)
            batch = np.concatenate([batch, pad])
        return batch

    def run(batch):
        out = serve(torch.from_numpy(batch))
        if output_kind != "labels":
            out = out.argmax(dim=-1)
        return out.to(torch.int32).cpu().numpy()

    done = 0
    t0 = time.perf_counter()
    t_first: Optional[float] = None  # after batch 0
    try:
        depth = min(max(args.prefetch, 1), len(batches))
        pending = deque(batch_pool.submit(assemble, batches[b])
                        for b in range(depth))
        next_sub = depth
        save_futs = deque()
        for chunk in batches:
            batch = pending.popleft().result()
            if next_sub < len(batches):  # keep the decode pipeline full
                pending.append(batch_pool.submit(assemble, batches[next_sub]))
                next_sub += 1
            t_dev = time.perf_counter()
            pred = run(batch)
            device_batches.append(time.perf_counter() - t_dev)
            for j, p in enumerate(chunk):
                if keep_predictions:
                    kept[p] = pred[j]
                save_futs.append(save_pool.submit(
                    clock.timed, "save", _save_prediction, pred[j],
                    os.path.basename(p), args.out_dir, args.dataset))
            done += len(chunk)
            if t_first is None:
                t_first = time.perf_counter()
            # each queued save pins a full-size prediction: at most ~4
            # batches of them in flight
            while len(save_futs) > 4 * n:
                save_futs.popleft().result()
        for f in save_futs:
            f.result()
    finally:
        frame_pool.shutdown()
        batch_pool.shutdown()
        save_pool.shutdown()
    t_end = time.perf_counter()
    wall = t_end - t0
    steady = (1000.0 * (t_end - t_first) / (done - n)
              if t_first is not None and done > n else None)
    msg = (f"saved {done} predictions to {args.out_dir} "
           f"({1000.0 * wall / done:.1f} ms/image incl. host IO")
    if steady is not None:
        msg += f"; steady-state after the first batch: {steady:.1f}"
    print(msg + ")")
    result = {"images": done, "ms_per_image": 1000.0 * wall / done,
              "steady_ms_per_image": steady,
              "seconds": {**clock.s, "device": sum(device_batches)},
              "device_batches": device_batches, "wall": wall}
    if keep_predictions:
        result["predictions"] = kept
    return result


if __name__ == "__main__":
    main()
