"""Where a train step's device time goes, by kernel, on one GPU.

    python -m s2r_tpu_torch.tools.profile_train
        [--method {output_adapt,feature_adapt,source_only}] [--batch N]
        [--height H] [--width W] [--dtype bf16] [--steps 3] [--rows 30]
        [--conv-shapes N] [--backbone mobilenet] [--remat]
        [--fast-pad-stats] [--s2d-convs N] [--max-batch]

Builds the method's step with s2r_tpu_torch.train.setup.build_method
(DeepLab-V3+ on --backbone, by default MobileNetV2, os 16; DRN's ASPP
runs at output stride 8; seeded weights) in bench.py's
configuration of that method (``BENCH``; --batch, --height and --width
override it): output_adapt and feature_adapt at 512x1024 batch 8 (the
train and train_feature cells), source_only at 513x513 batch 4
(train_source).  It runs two warm-up steps, then times `steps` + 2
unprofiled steps (host clock around each synchronized step; the median
and the source images/s), and profiles `steps` steps with torch.profiler:
the wall time per step, the summed device time of all kernels, the
device's idle share (1 - device / wall), the number of device kernels a
step, the hand-written kernels' share, and the kernels that take the most
device time.  With --conv-shapes N it profiles one more step recording
input shapes and prints the N convolution calls (forward and backward,
grouped by input shapes) that take the most device time.  It prints the
peak device memory of the timed steps.  --remat and --fast-pad-stats are
the drivers' flags; --s2d-convs N sets the output-space discriminator's
``s2d_convs`` (models/discriminator.py).  --max-batch finds instead the
largest batch whose step fits on the card (doubling, then bisecting;
a step that runs out of memory is caught) and prints its peak memory.
It reads only the package on the import path, so it also profiles
another checkout of the port: ``PYTHONPATH=<checkout> python
s2r_tpu_torch/tools/profile_train.py``.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.train.setup import build_method

# bench.py's cell of each method: ((H, W), batch, Config fields)
# (bench.py:493-531, :167-198 and :201-236).
BENCH = {"output_adapt": ((512, 1024), 8, {}),
         "feature_adapt": ((512, 1024), 8, {"epochs": 200}),
         "source_only": ((513, 513), 4, {"epochs": 50, "dataset": "gtav"})}


def bench_batch(method: str, n: int, hw, device, gen: torch.Generator,
                num_classes: int = 19):
    """A random train batch of the method's keys, on `device`."""
    image = "image" if method == "source_only" else "src_image"
    label = "label" if method == "source_only" else "src_label"
    out = {image: torch.randn((n,) + tuple(hw) + (3,), device=device,
                              generator=gen),
           label: torch.randint(0, num_classes, (n,) + tuple(hw),
                                device=device, generator=gen)}
    if method != "source_only":
        out["tgt_image"] = torch.randn((n,) + tuple(hw) + (3,),
                                       device=device, generator=gen)
    return out


# Substrings of the hand-written kernels' names (s2r_tpu_torch/csrc), and
# pair_sums, the BatchNorm sums of checkouts before bn_sums.
OWN_KERNELS = ("dw3x3", "slab_fold", "bn_sums", "bn_fold", "bn_elementwise",
               "disc_conv1", "requant", "pair_sums")


def fits(method, state, n, hw, cfg) -> bool:
    """Whether one step of `method` at batch `n` runs on the card (its
    peak memory printed)."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        method.step_fn(state, bench_batch(method.name, n, hw, "cuda", gen,
                                          cfg.num_classes))
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        print(f"[max-batch] batch {n}: out of memory")
        return False
    print(f"[max-batch] batch {n}: fits, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return True


def max_batch(method, state, hw, cfg, limit: int = 256) -> int:
    """The largest batch (up to `limit`) whose step fits: 1, 2, 4, ...
    until one does not, then bisection."""
    lo, hi = 0, 1
    while hi <= limit and fits(method, state, hi, hw, cfg):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(method, state, mid, hw, cfg) else (lo, mid)
    return lo


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="output_adapt", choices=list(BENCH))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=30)
    ap.add_argument("--conv-shapes", type=int, default=0)
    ap.add_argument("--backbone", default="mobilenet")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--fast-pad-stats", action="store_true")
    ap.add_argument("--s2d-convs", type=int, default=0)
    ap.add_argument("--max-batch", action="store_true")
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    (h, w), n, fields = BENCH[a.method]
    a.height, a.width = a.height or h, a.width or w
    a.batch = a.batch or n
    cfg = Config(precision=a.dtype, backbone=a.backbone, remat=a.remat,
                 pad_stats=not a.fast_pad_stats, **fields)
    method = build_method(cfg, iters_per_epoch=1000, method=a.method,
                          generator=torch.Generator().manual_seed(0))
    if a.s2d_convs:
        if a.method != "output_adapt":
            ap.error("--s2d-convs: the output-space discriminator is "
                     "output_adapt's")
        method.aux_model.s2d_convs = a.s2d_convs
    state = method.init_state()
    flags = (" --remat" * a.remat + " --fast-pad-stats" * a.fast_pad_stats
             + f" --s2d-convs {a.s2d_convs}" * bool(a.s2d_convs))
    if a.max_batch:
        n = max_batch(method, state, (a.height, a.width), cfg)
        print(f"[max-batch] {a.method} {a.backbone}, {a.height}x{a.width}, "
              f"{a.dtype}{flags}: the largest batch that fits is {n}")
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = bench_batch(a.method, a.batch, (a.height, a.width), "cuda", gen,
                        cfg.num_classes)
    print(f"[setup] {a.method} {a.backbone}, {a.height}x{a.width} batch "
          f"{a.batch}, {a.dtype}{flags}")
    for _ in range(2):
        state, _ = method.step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(a.steps + 2):
        t0 = time.perf_counter()
        state, _ = method.step_fn(state, batch)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(runs)
    print(f"[train] unprofiled: {ms:.3f} ms/step (median of {len(runs)}: "
          f"{', '.join(f'{r:.3f}' for r in runs)}), "
          f"{a.batch * 1e3 / ms:.2f} source images/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.steps):
            state, _ = method.step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / a.steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[train] wall {wall_ms:.3f} ms/step; the profiler saw no "
              "device events")
        return
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / a.steps
    own_ms = sum(e.self_device_time_total for e in kernels
                 if any(s in e.key for s in OWN_KERNELS)) / 1e3 / a.steps
    n_kernels = sum(e.count for e in kernels) / a.steps
    print(f"[train] wall {wall_ms:.3f} ms/step, device {dev_ms:.3f} ms/step, "
          f"idle share {max(0.0, 1 - dev_ms / wall_ms):.3f}, "
          f"{n_kernels:.0f} device kernels/step, hand-written kernels "
          f"{own_ms:.3f} ms ({100 * own_ms / dev_ms:.1f}%)")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:a.rows]:
        ms = e.self_device_time_total / 1e3 / a.steps
        print(f"[train] {ms:9.3f} ms {100 * ms / dev_ms:5.1f}% "
              f"x{e.count // a.steps:<5d} {e.key[:110]}")
    if a.conv_shapes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            state, _ = method.step_fn(state, batch)
            torch.cuda.synchronize()
        convs = [e for e in prof.key_averages(group_by_input_shape=True)
                 if e.key in ("aten::convolution",
                              "aten::convolution_backward")]
        convs.sort(key=lambda e: -e.device_time_total)
        for e in convs[:a.conv_shapes]:
            shapes = [s for s in e.input_shapes if s][:3]
            print(f"[conv] {e.device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
                  f"{e.key[6:]} {shapes}")


if __name__ == "__main__":
    main()
