#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (s2r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one H100

Phases, each of which must pass:

1. Build the hand-written kernels (s2r_tpu_torch/csrc/*.cu) with plain nvcc,
   one process per source, into s2r_tpu_torch/_build/.
2. Hold each kernel against its plain PyTorch version on the card, at every
   shape the serving path gives it (2048x1024 batch 8 and 513x513 batch 1),
   and time kernel, plain version and, where one exists, the one PyTorch
   call that computes the same function (library_ms, a yardstick only).
   Tolerances: depthwise float32 max|diff| <= 1e-5 * max(1, max|ref|);
   bfloat16 |diff| <= 1e-2 * max(1, |ref|) elementwise; requant bit-exact.
3. Serve DeepLab-V3+ MobileNetV2 (output stride 16, 19 classes, full width,
   weights from a seeded torch.Generator, BatchNorm statistics perturbed):
   batch-1 513x513 float32 logits against the same model on the CPU through
   the plain versions (max|diff| <= 1e-4 * max(1, max|ref|), labels >= 99.9%
   equal), decoder-int8 labels likewise (>= 99%), then rgb8 2048x1024 batch 8
   to labels in exact and decoder-int8 mode in bfloat16, timed with CUDA
   events.  The launch counts of one exact and one int8 batch-8 call show
   that the serving path went through both kernels.
4. Print the kernels line, the card's name and power limit, and as the last
   line {"ok": true, "device": {...}}.

Without a CUDA device, or outside a checkout holding s2r_tpu_torch, it exits
non-zero and prints no result.  Float32 convs run with TF32 off.  It writes
only the kernel build directory.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
FULL_HW = (1024, 2048)
BATCH = 8
CHECK_HW = (513, 513)
DEV = "cuda"


class Failed(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Failed(what)


def log(msg):
    print(msg, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dw_shapes(hw, block_plan):
    """(C, H, W, dilation) of each stride-1 depthwise conv of one forward."""
    h, w = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1  # the 3x3/s2 stem
    shapes = []
    for in_ch, _, stride, dilation, t in block_plan(16):
        if stride == 1:
            shapes.append((in_ch * t, h, w, dilation))
        else:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return shapes


def dw_check(dw, x, k, d):
    """Kernel against plain version; returns max_abs_err or raises."""
    got = dw.depthwise_conv3x3(x, k, d)
    ref = dw.depthwise_conv3x3_plain(x, k, d)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().clamp(min=1.0)
    if x.dtype == torch.float32:
        ok = float(diff.max()) <= 1e-5 * float(scale.max())
    else:
        ok = bool((diff <= 1e-2 * scale).all())
    err = float(diff.max())
    require(ok, f"depthwise {tuple(x.shape)} d={d} {x.dtype}: max_abs_err {err}")
    return err


def randn(shape, dtype, gen, offset=0):
    """A contiguous tensor whose data starts `offset` elements into its
    buffer (offset 1 breaks 16-byte alignment)."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, device=DEV, generator=gen).to(dtype)
    return buf[offset:].view(shape)


def check_depthwise(dw):
    """Phase 2a.  Returns the kernels-line entry for one batch-8 2048x1024
    bfloat16 forward (14 launches)."""
    import torch.nn.functional as F

    from s2r_tpu_torch.models.mobilenet import block_plan

    main = dw_shapes(FULL_HW, block_plan)
    require(len(main) == 14, f"expected 14 stride-1 depthwise convs, {main}")
    cases = [(BATCH,) + s for s in sorted(set(main))]
    cases += [(1,) + s for s in sorted(set(dw_shapes(CHECK_HW, block_plan)))]
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    per_shape = {}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    log("[depthwise] N C H W d dtype: max_abs_err | kernel_ms plain_ms "
        "library_ms bound_ms")
    for n, c, h, w, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dtype, gen)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            err = dw_check(dw, x, k, d)
            worst[dtype] = max(worst[dtype], err)
            wt = k.permute(2, 0, 1).unsqueeze(1)
            xv = x.permute(0, 3, 1, 2)
            kern = cuda_ms(lambda: dw.depthwise_conv3x3(x, k, d))
            plain = cuda_ms(lambda: dw.depthwise_conv3x3_plain(x, k, d))
            lib = cuda_ms(lambda: F.conv2d(xv, wt, padding=d, dilation=d,
                                           groups=c))
            isz = x.element_size()
            bnd, by = bound_ms(2 * x.numel() * isz + k.numel() * isz,
                               18 * x.numel())
            per_shape[(n, c, h, w, d, dtype)] = (kern, plain, lib, bnd, by, err)
            log(f"[depthwise] {n} {c} {h} {w} {d} {str(dtype)[6:]}: {err:.3g} "
                f"| {kern:.4f} {plain:.4f} {lib:.4f} {bnd:.4f}")
            del x, k, xv
    # The one-channel-at-a-time path: C off the 16-byte vector, and an
    # unaligned (but contiguous) input.
    for (n, c, h, w, d), offset in (((2, 7, 33, 65, 2), 0),
                                    ((2, 20, 17, 19, 1), 0),
                                    ((1, 24, 17, 19, 2), 1)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dtype, gen, offset)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            err = dw_check(dw, x, k, d)
            worst[dtype] = max(worst[dtype], err)
    log("[depthwise] scalar-path cases (C=7, C=20, unaligned input) pass")
    rows = [per_shape[(BATCH,) + s + (torch.bfloat16,)] for s in main]
    entry = {"name": "depthwise_conv3x3", "route": "cuda",
             "source": "s2r_tpu_torch/csrc/depthwise.cu",
             "replaces": "s2r_tpu/ops/pallas/depthwise.py:155",
             "launches": None,
             "max_abs_err": max(r[5] for r in rows),
             "ms": sum(r[0] for r in rows),
             "plain_ms": sum(r[1] for r in rows),
             "bound_ms": sum(r[3] for r in rows),
             "bound_by": "bytes" if all(r[4] == "bytes" for r in rows)
             else "operations",
             "library_ms": sum(r[2] for r in rows)}
    log(f"[depthwise] all checks passed; worst max_abs_err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; one "
        f"2048x1024 batch-8 bf16 forward (14 launches): kernel "
        f"{entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, cuDNN "
        f"{entry['library_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms")
    return entry


def requant_inputs(shape, gen):
    """Accumulators in the int8 convs' range, with channels that land on
    exact .5 ties (m = 0.5 on odd x; m = 1, b = 0.5) and past both clamp
    ends."""
    c = shape[-1]
    x = torch.randint(-2 ** 20, 2 ** 20, shape, device=DEV, generator=gen,
                      dtype=torch.int32)
    m = torch.rand(c, device=DEV, generator=gen) * 1e-4
    b = torch.randn(c, device=DEV, generator=gen)
    q = c // 4
    x[..., :q] = torch.randint(-41, 300, shape[:-1] + (q,), device=DEV,
                               generator=gen, dtype=torch.int32)
    m[:q], b[:q] = 0.5, 0.0
    x[..., q:2 * q] = torch.randint(-20, 150, shape[:-1] + (q,),
                                    device=DEV, generator=gen,
                                    dtype=torch.int32)
    m[q:2 * q], b[q:2 * q] = 1.0, 0.5
    return x, m, b


def check_requant(rq):
    """Phase 2b.  Returns the kernels-line entry at the batch-8 2048x1024
    decoder shape (one launch per int8 forward)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    main = (BATCH, FULL_HW[0] // 4, FULL_HW[1] // 4, 256)
    entry = None
    for shape in (main, (3, 65, 129, 200), (2, 9, 11, 30)):  # C=30: scalar
        x, m, b = requant_inputs(shape, gen)
        got = rq.requant_s32_to_s8(x, m, b)
        ref = rq.requant_plain(x, m, b)
        torch.cuda.synchronize()
        require(got.dtype == torch.int8 and torch.equal(got, ref),
                f"requant {shape}: not bit-exact, "
                f"{int((got != ref).sum())} elements differ")
        ties = int((x[..., :shape[-1] // 4] % 2 != 0).sum())
        kern = cuda_ms(lambda: rq.requant_s32_to_s8(x, m, b))
        plain = cuda_ms(lambda: rq.requant_plain(x, m, b))
        bnd, by = bound_ms(5 * x.numel() + 8 * shape[-1], 2 * x.numel())
        log(f"[requant] {shape}: bit-exact ({ties} exact .5 ties) | kernel "
            f"{kern:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms")
        if shape == main:
            entry = {"name": "requant_s32_to_s8", "route": "cuda",
                     "source": "s2r_tpu_torch/csrc/requant.cu",
                     "replaces": "s2r_tpu/ops/pallas/requant.py:69",
                     "launches": None,
                     "max_abs_err": float((got.int() - ref.int()).abs().max()),
                     "ms": kern,
                     "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                     "library_ms": None}
        del x, m, b, got, ref
    return entry


def perturb_bn_stats(model, gen):
    """Running mean ~ N(0, 0.1), running var ~ U(0.5, 1.5), drawn on the CPU
    in module order, so every copy built from the same seeds agrees."""
    from s2r_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


def build_model(dtype, device):
    from s2r_tpu_torch.models.deeplab import DeepLab

    model = DeepLab(num_classes=19, output_stride=16, dtype=dtype,
                    device=device,
                    generator=torch.Generator().manual_seed(SEED))
    perturb_bn_stats(model, torch.Generator().manual_seed(SEED + 1))
    return model


def reset(counted):
    for fn in counted:
        fn.launches = 0


def serve_check_513(dw, rq):
    """Phase 3a: 513x513 batch 1 float32, card against CPU."""
    from s2r_tpu_torch.io.quant import calibrate_decoder_int8
    from s2r_tpu_torch.io.serving import make_serving_fn

    gpu, cpu = build_model("f32", DEV), build_model("f32", "cpu")
    sd_g, sd_c = gpu.state_dict(), cpu.state_dict()
    require(all(torch.equal(sd_g[k].cpu(), sd_c[k]) for k in sd_c),
            "card and CPU models hold different weights")
    rs = np.random.RandomState(SEED)
    image = rs.randn(1, *CHECK_HW, 3).astype(np.float32)
    reset((dw.depthwise_conv3x3, rq.requant_s32_to_s8))
    got = make_serving_fn(gpu, output="logits")(image)
    torch.cuda.synchronize()
    require(dw.depthwise_conv3x3.launches == 14,
            f"513 forward: {dw.depthwise_conv3x3.launches} depthwise launches")
    got = got.cpu()
    ref = make_serving_fn(cpu, output="logits")(image)
    require(got.shape == ref.shape == (1, *CHECK_HW, 19)
            and bool(torch.isfinite(got).all()), "513 logits shape/finite")
    err = float((got - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"[serve 513] float32 logits card vs CPU: max_abs_err {err:.3g} "
        f"(tol {tol:.3g}, max|logit| {float(ref.abs().max()):.3g}), "
        f"label agreement {100 * agree:.4f}%")
    require(err <= tol and agree >= 0.999, "513 logits disagree with the CPU")

    calib = [rs.randn(1, *CHECK_HW, 3).astype(np.float32) for _ in range(2)]
    scales = calibrate_decoder_int8(cpu, calib)
    scales_g = calibrate_decoder_int8(gpu, calib)
    rel = max(abs(scales_g[k] - scales[k]) / scales[k] for k in scales)
    reset((dw.depthwise_conv3x3, rq.requant_s32_to_s8))
    lab_g = make_serving_fn(gpu, quant="decoder_int8",
                            quant_scales=scales)(image)
    torch.cuda.synchronize()
    require(rq.requant_s32_to_s8.launches == 1, "513 int8: requant not run")
    lab_c = make_serving_fn(cpu, quant="decoder_int8",
                            quant_scales=scales)(image)
    agree8 = float((lab_g.cpu() == lab_c).float().mean())
    log(f"[serve 513] decoder-int8 labels card vs CPU: agreement "
        f"{100 * agree8:.4f}%; calibration scales card vs CPU rel diff "
        f"{rel:.3g}")
    require(agree8 >= 0.99 and rel <= 1e-3, "513 int8 disagrees with the CPU")
    del gpu, cpu


def serve_full(dw, rq):
    """Phase 3b: rgb8 2048x1024 batch 8 to labels, bf16, exact and int8."""
    from s2r_tpu_torch.io.quant import calibrate_decoder_int8
    from s2r_tpu_torch.io.serving import make_serving_fn

    model = build_model("bf16", DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)

    def rgb8():
        return torch.randint(0, 256, (BATCH, *FULL_HW, 3), device=DEV,
                             generator=gen, dtype=torch.uint8)

    scales = calibrate_decoder_int8(model, [rgb8(), rgb8()], input="rgb8")
    log(f"[serve 2048x1024] calibration scales {scales}")
    images = rgb8()
    fns = {"exact": make_serving_fn(model, input="rgb8"),
           "decoder_int8": make_serving_fn(model, input="rgb8",
                                           quant="decoder_int8",
                                           quant_scales=scales)}
    labels = {}
    for mode, fn in fns.items():
        out = fn(images)
        torch.cuda.synchronize()
        require(out.shape == (BATCH, *FULL_HW) and out.dtype == torch.int32
                and int(out.min()) >= 0 and int(out.max()) < 19,
                f"{mode} labels: {tuple(out.shape)} {out.dtype}")
        labels[mode] = out
    agree = float((labels["exact"] == labels["decoder_int8"]).float().mean())
    log(f"[serve 2048x1024] int8 vs exact label agreement {100 * agree:.3f}% "
        "(random weights; informational)")
    del labels

    ms = {}
    torch.cuda.reset_peak_memory_stats()
    for mode, fn in fns.items():
        for _ in range(2):
            fn(images)
        runs = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(images)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / BATCH)
        ms[mode] = statistics.median(runs)
        log(f"[serve 2048x1024] {mode}: {ms[mode]:.3f} ms/image (median of "
            f"5 batch-{BATCH} calls: {', '.join(f'{r:.3f}' for r in runs)})")
    log(f"[serve 2048x1024] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # The main-path run that the kernels line counts: one call per mode.
    reset((dw.depthwise_conv3x3, rq.requant_s32_to_s8))
    for fn in fns.values():
        fn(images)
    torch.cuda.synchronize()
    launches = {"depthwise_conv3x3": dw.depthwise_conv3x3.launches,
                "requant_s32_to_s8": rq.requant_s32_to_s8.launches}
    log(f"[serve 2048x1024] launches in one exact + one int8 call: {launches}")
    require(launches == {"depthwise_conv3x3": 28, "requant_s32_to_s8": 1},
            f"unexpected launch counts {launches}")
    return ms, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from s2r_tpu_torch.ops.kernels import build
        from s2r_tpu_torch.ops.kernels import depthwise as dw
        from s2r_tpu_torch.ops.kernels import requant as rq
    except ImportError as e:
        print(f"chip_smoke: s2r_tpu_torch not found beside {__file__}: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        libs = build.build_all()
        log(f"[build] {len(libs)} kernels built with nvcc "
            f"({' '.join(build.NVCC_FLAGS)}) in {time.perf_counter() - t0:.1f} s")
        smi = card()
        log(f"[card] {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        kernels = [check_depthwise(dw), check_requant(rq)]
        torch.cuda.empty_cache()
        serve_check_513(dw, rq)
        torch.cuda.empty_cache()
        ms, launches = serve_full(dw, rq)
        for k in kernels:
            k["launches"] = launches[k["name"]]
    except (Failed, RuntimeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    log(f"[done] ms/image exact {ms['exact']:.3f}, decoder-int8 "
        f"{ms['decoder_int8']:.3f} (bf16, rgb8 {FULL_HW[1]}x{FULL_HW[0]} "
        f"batch {BATCH}) on {smi}; {time.perf_counter() - t_start:.1f} s "
        "after imports")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
