"""Time the depthwise kernels' launch plans at the port's path shapes, on
one GPU.

    python -m s2r_tpu_torch.tools.depthwise_plans [--reps 5] [--ptxas]

For each stride-1 depthwise shape of MobileNetV2 os16 (2048x1024 batch 8
for serving, 512x1024 batch 8 for the train step) and bf16 inputs: the
forward (serving, and the train step's forward and dx) and dk, each at
the wrapper's default plan (ops/kernels/depthwise.py sweep_plan) and at a
few candidate tunings, beside cuDNN's call for the same function and a
copy of x (what moving the bytes costs).  Every output is checked against
the plain version first.  Times are the median over --reps rounds of
CUDA-event means of 20 launches, the candidates taking turns within a
round; totals weight each shape by its launches on the path.  The kernels
are called through their C entries with a prepared plan, so these times
leave out the wrapper's host work.  --ptxas prints the registers and
spills of each kernel instance (nvcc -Xptxas -v).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import statistics
import subprocess

import torch
import torch.nn.functional as F

from s2r_tpu_torch.models.mobilenet import block_plan
from s2r_tpu_torch.ops.kernels import build
from s2r_tpu_torch.ops.kernels import depthwise as dw


def candidates(kind):
    """The default tuning and variants of it, by name: h, w, c -> tuning."""
    def vary(**kw):
        return lambda h, w, c: dataclasses.replace(
            dw.default_tuning(kind, h, w, c, 2), **kw)
    if kind == "forward":
        return {"default": vary(), "threads64": vary(threads=64),
                "threads128": vary(threads=128), "ahead3": vary(ahead=3),
                "blocks1056": vary(target_blocks=1056)}
    return {"default": vary(), "slab_fold": vary(fold_loads=0),
            "threads256": vary(threads=256, min_rows=16),
            "ahead3": vary(ahead=3)}


def shapes(hw):
    """(C, H, W, d) of the 14 stride-1 depthwise convs of one forward."""
    h, w = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1
    out = []
    for in_ch, _, stride, dilation, t in block_plan(16):
        if stride == 1:
            out.append((in_ch * t, h, w, dilation))
        else:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return out


def event_ms(fn, iters=20):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch(kind, x, other, d, plan):
    """One launch through the C entry with `plan`; returns y or dk."""
    lib = dw._lib()
    n, h, w, c = x.shape
    fields = (ctypes.c_int64 * dw.PLAN_FIELDS)(*plan.fields())
    if kind == "forward":
        y = torch.empty_like(x)
        err = getattr(lib, dw._DTYPES[x.dtype])(
            x.data_ptr(), other.data_ptr(), y.data_ptr(), n, h, w, c, d,
            fields, build.stream(x))
        build.check(err, "forward")
        return y
    dk = torch.empty((3, 3, c), dtype=torch.float32, device=x.device)
    part = torch.empty((max(1, dw.dk_scratch_floats(plan, c)),),
                       dtype=torch.float32, device=x.device)
    err = getattr(lib, dw._DK[x.dtype])(
        x.data_ptr(), other.data_ptr(), part.data_ptr(), dk.data_ptr(), n, h,
        w, c, d, fields, build.stream(x))
    build.check(err, "dk")
    return dk


def check(kind, out, ref):
    if kind == "forward":
        diff = (out.float() - ref.float()).abs()
        return bool((diff <= 1e-2 * ref.float().abs().clamp(min=1.0)).all())
    err = (out.double() - ref.double()).abs().max() / ref.double().abs().max()
    return float(err) <= 1e-4


def run_path(name, kind, path_shapes, per_layer, reps, gen):
    pols = candidates(kind)
    totals = dict.fromkeys(list(pols) + ["cudnn", "copy"], 0.0)
    for c, h, w, d in sorted(set(path_shapes)):
        launches = per_layer * path_shapes.count((c, h, w, d))
        x = torch.randn((8, h, w, c), device="cuda", generator=gen).bfloat16()
        xv = x.permute(0, 3, 1, 2)
        if kind == "forward":
            other = (torch.randn((3, 3, c), device="cuda", generator=gen)
                     / 3).bfloat16()
            ref = dw.depthwise_conv3x3_plain(x, other, d)
            wt = other.permute(2, 0, 1).unsqueeze(1)
            library = lambda: F.conv2d(xv, wt, padding=d, dilation=d, groups=c)
        else:
            other = torch.randn((8, h, w, c), device="cuda",
                                generator=gen).bfloat16()
            ref = dw.depthwise_dk_plain(x, other, d)
            gv = other.permute(0, 3, 1, 2)
            library = lambda: torch.nn.grad.conv2d_weight(
                xv, (c, 1, 3, 3), gv, padding=d, dilation=d, groups=c)
        plans = {k: dw.sweep_plan(kind, 8, h, w, c, d, 2, True, f(h, w, c))
                 for k, f in pols.items()}
        for k, plan in plans.items():
            out = launch(kind, x, other, d, plan)
            torch.cuda.synchronize()
            if not check(kind, out, ref):
                raise SystemExit(f"{name} C{c} {h}x{w} d{d} {k}: wrong")
        copy_out = torch.empty_like(x)
        runs = {k: [] for k in totals}
        for _ in range(reps):
            for k, plan in plans.items():
                runs[k].append(event_ms(lambda: launch(kind, x, other, d, plan)))
            runs["cudnn"].append(event_ms(library))
            runs["copy"].append(event_ms(lambda: copy_out.copy_(x)))
        med = {k: statistics.median(v) for k, v in runs.items()}
        for k, v in med.items():
            totals[k] += launches * v
        print(f"[{name}] C{c} {h}x{w} d{d} x{launches} (ms a launch): "
              + " ".join(f"{k} {v:.4f}" for k, v in med.items()), flush=True)
        del x, other, ref
    print(f"[{name}] total: " + " ".join(f"{k} {v:.3f}"
                                         for k, v in totals.items()),
          flush=True)


def ptxas():
    out = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(build.BUILD_DIR / "ptxas_depthwise.so"),
         str(build.SRC_DIR / "depthwise.cu")],
        capture_output=True, text=True, check=True)
    name, spill = None, ""
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and name:
            kernel = re.search(r"(dw3x3_dk_sweep|dw3x3_sweep|slab_fold)", name)
            dtype = "bf16" if "nv_bfloat16" in name else "f32"
            vec = re.findall(r"Li(\d+)E", name)
            print(f"[ptxas] {kernel.group(1)} {dtype} V={vec}: "
                  f"{line.split('info    :')[-1].strip()}; {spill}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("depthwise_plans: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}")
    build.build_all(["depthwise"])
    if args.ptxas:
        ptxas()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    serve, train = shapes((1024, 2048)), shapes((512, 1024))
    run_path("serve forward", "forward", serve, 1, args.reps, gen)
    run_path("train forward+dx", "forward", train, 4, args.reps, gen)
    run_path("train dk", "dk", train, 2, args.reps, gen)


if __name__ == "__main__":
    main()
