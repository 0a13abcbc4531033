"""Where a serving call's device time goes, by kernel, on one GPU.

    python -m s2r_tpu_torch.tools.profile_serving [--batch 8] [--height 1024]
        [--width 2048] [--dtype bf16] [--rows 25]

Builds DeepLab-V3+ MobileNetV2 (seeded weights), serves rgb8 frames to
labels in exact and decoder-int8 mode, and after two warm-up calls profiles
three calls of each with torch.profiler.  Prints, per mode, the wall time
per call (host clock around a synchronized call), the summed device time of
all kernels, the device's idle share (1 - device / wall), and the kernels
that take the most device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from s2r_tpu_torch.io.quant import calibrate_decoder_int8
from s2r_tpu_torch.io.serving import make_serving_fn
from s2r_tpu_torch.models.deeplab import DeepLab


def profile_mode(name, fn, images, calls, rows):
    for _ in range(2):
        fn(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(images)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{name}] wall {wall_ms:.3f} ms/call; the profiler saw no "
              "device events")
        return
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    print(f"[{name}] wall {wall_ms:.3f} ms/call, device {dev_ms:.3f} ms/call, "
          f"idle share {max(0.0, 1 - dev_ms / wall_ms):.3f}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:rows]:
        ms = e.self_device_time_total / 1e3 / calls
        print(f"[{name}] {ms:9.3f} ms {100 * ms / dev_ms:5.1f}% "
              f"x{e.count // calls:<4d} {e.key[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--rows", type=int, default=25)
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    model = DeepLab(dtype=a.dtype, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rgb8():
        return torch.randint(0, 256, (a.batch, a.height, a.width, 3),
                             device="cuda", generator=gen, dtype=torch.uint8)

    scales = calibrate_decoder_int8(model, [rgb8(), rgb8()], input="rgb8")
    images = rgb8()
    print(f"[setup] rgb8 {a.height}x{a.width} batch {a.batch}, {a.dtype}")
    profile_mode("exact", make_serving_fn(model, input="rgb8"), images,
                 a.calls, a.rows)
    profile_mode("decoder_int8",
                 make_serving_fn(model, input="rgb8", quant="decoder_int8",
                                 quant_scales=scales),
                 images, a.calls, a.rows)


if __name__ == "__main__":
    main()
