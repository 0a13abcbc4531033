"""Where a serving call's device time goes, by kernel, on one GPU.

    python -m s2r_tpu_torch.tools.profile_serving [--batch 8] [--height 1024]
        [--width 2048] [--dtype bf16] [--rows 25] [--backbone mobilenet]
        [--conv-shapes N]

Builds DeepLab-V3+ on `--backbone` (os 16, seeded weights; DRN's ASPP
runs at output stride 8), serves rgb8 frames to labels in exact and
decoder-int8 mode, and after two warm-up calls profiles three calls of
each with torch.profiler.  Prints, per mode, the wall time per call (host
clock around a synchronized call), the summed device time of all
kernels, the device's idle share (1 - device / wall), and the kernels
that take the most device time; then times the exact call with every
eval-mode BatchNorm made the identity (``eval_bn_share``) and prints the
share of the call those BatchNorms take.  With
--conv-shapes N it profiles one more exact call recording input shapes
and prints the N convolutions (grouped by input shapes) that take the
most device time.
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
from s2r_tpu_torch.models.layers import BatchNorm


def _events_ms(fn, images, calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        fn(images)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn(images)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def eval_bn_share(fn, images, calls=3):
    """(ms of fn(images), ms with every eval-mode BatchNorm the identity,
    the share of the first that those BatchNorms take), by CUDA events.
    The second call computes other values: it is timed, never used."""
    ms = _events_ms(fn, images, calls)
    forward = BatchNorm.forward

    def identity(self, x, ring=False, zero_pad_width=0):
        if self.training:
            return forward(self, x, ring, zero_pad_width)
        return (x, torch.zeros_like(self.bias)) if ring else x

    BatchNorm.forward = identity
    try:
        without = _events_ms(fn, images, calls)
    finally:
        BatchNorm.forward = forward
    return ms, without, max(0.0, 1.0 - without / ms)


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
    ap.add_argument("--backbone", default="mobilenet")
    ap.add_argument("--conv-shapes", type=int, default=0)
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    model = DeepLab(dtype=a.dtype, generator=torch.Generator().manual_seed(0),
                    backbone=a.backbone)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rgb8():
        return torch.randint(0, 256, (a.batch, a.height, a.width, 3),
                             device="cuda", generator=gen, dtype=torch.uint8)

    scales = calibrate_decoder_int8(model, [rgb8(), rgb8()], input="rgb8")
    images = rgb8()
    print(f"[setup] {a.backbone}, rgb8 {a.height}x{a.width} batch "
          f"{a.batch}, {a.dtype}")
    exact = make_serving_fn(model, input="rgb8")
    profile_mode("exact", exact, images, a.calls, a.rows)
    ms, without, share = eval_bn_share(exact, images, a.calls)
    print(f"[bn-share] exact {ms:.3f} ms/call (CUDA events), with the eval "
          f"BatchNorms the identity {without:.3f} ms/call: share "
          f"{share:.3f}")
    if a.conv_shapes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            exact(images)
            torch.cuda.synchronize()
        convs = [e for e in prof.key_averages(group_by_input_shape=True)
                 if e.key == "aten::convolution"]
        convs.sort(key=lambda e: -e.device_time_total)
        for e in convs[:a.conv_shapes]:
            print(f"[conv] {e.device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<3d} {[s for s in e.input_shapes if s][:2]}")
    profile_mode("decoder_int8",
                 make_serving_fn(model, input="rgb8", quant="decoder_int8",
                                 quant_scales=scales),
                 images, a.calls, a.rows)


if __name__ == "__main__":
    main()
