#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (s2r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one H100

Phases, each of which must pass:

1. Build the hand-written kernels (s2r_tpu_torch/csrc/*.cu) with plain nvcc,
   one process per source, all at once, into s2r_tpu_torch/_build/.
2. Hold each kernel against its plain PyTorch version on the card, at every
   shape the serving path (2048x1024 batch 8, 513x513 batch 1) and the
   train step (512x1024 batch 8) give it, and time kernel, plain version
   and, where one exists, the one PyTorch call that computes the same
   function (library_ms, a yardstick only).  Tolerances: depthwise
   forward and dx float32 max|diff| <= 1e-5 * max(1, max|ref|), bfloat16
   |diff| <= 1e-2 * max(1, |ref|) elementwise; depthwise dk max|diff| <=
   1e-4 * max|ref| (a reduction over ~1e7 terms in another order); the
   four BatchNorm entries (statistics with the running statistics, y, the
   backward sums, dx; phase 2d) max|diff| <= 1e-5 (float32) and 1e-4
   (bfloat16) of max|ref| for each per-channel row and each output, and
   the whole composite timed against native_batch_norm + its backward;
   disc_conv1 (bfloat16 on the tensor cores, float32 on the CUDA cores) as
   the depthwise forward; requant bit-exact; the BatchNorm entries and dk,
   which fold in a fixed order, bit-identical on a repeated call.  The
   depthwise tile sweeps are also held at edge shapes (phases 2a, 2c:
   tiles wider than the image, H = W = 1, odd H at dilation 2, dilations
   4 and 40, tile edges inside a halo, blocks streaming many tiny images,
   C = 7 and unaligned inputs), and their kernels-line entries list each
   path's shapes (per_shape: C, H, W, d, launches, ms, library_ms,
   bound_ms a launch) with the count of shapes where the kernel is slower
   than its cuDNN call (slower_than_library).
   bound_ms is the larger of the bytes over 3.35 TB/s and the flops over
   the published peak for the operands' arithmetic (bfloat16 989 TFLOP/s
   on the tensor cores, float32 67 TFLOP/s).  Phase 2f runs each kernel
   that indexed in 32 bits on one input of more than 2^31 elements (the
   depthwise forward and requant split the batch, dk and disc_conv1 index
   in 64 bits) and compares the batch items at each side of the split and
   the last with the plain version.
3. Serve DeepLab-V3+ MobileNetV2 (output stride 16, 19 classes, full width,
   weights from a seeded torch.Generator, BatchNorm statistics perturbed):
   batch-1 513x513 float32 logits against the same model on the CPU through
   the plain versions (max|diff| <= 1e-4 * max(1, max|ref|), labels >= 99.9%
   equal), decoder-int8 labels likewise (>= 99%), then rgb8 2048x1024 batch 8
   to labels in exact and decoder-int8 mode in bfloat16, timed with CUDA
   events.  The launch counts of one exact and one int8 batch-8 call show
   that the serving path went through its kernels.
4. Train: the output-space adaptation step built by
   s2r_tpu_torch.train.setup.build_method.  (a) One step at 128x128 batch 2
   float32, dropout off, on the card and on the CPU (plain versions) from
   the same weights (BatchNorm scale and bias perturbed too, off the kink
   tie of the initial point; perturb_batchnorm in
   s2r_tpu_torch/tools/step_conditioning.py says why), and on the CPU in
   float64 as the exact reference: losses rtol 1e-4, BatchNorm running
   statistics within 1e-3 of each layer's largest, D's update of the same
   sign on >= 99% of elements, and G's gradient per leaf (read from SGD's
   momentum buffer) within 3e-2 relative L2 of the float64 one, or within
   3x the CPU float32 gradient's distance from it for that leaf if larger;
   leaves whose float64 gradient is zero up to rounding are left out.
   Float32 rounding alone moves the leaves by 0.5-1.1% at this size (the
   tool s2r_tpu_torch/tools/step_conditioning.py measures it; the tests
   in tests/test_torch_port_train_step_f64.py hold the float64 step to the
   JAX package's leaf by leaf).  (b) 512x1024 batch 8 bfloat16, the
   bench.py train configuration: 2 warm-up and 5 timed steps
   (CUDA events), ms/step, source images/s and peak memory, finite losses,
   and the launch counts of one step, with the BatchNorm layout copies.
5. Print the kernels line, the card's name and power limit, and as the last
   line {"ok": true, "device": {...}}.

Without a CUDA device, or outside a checkout holding s2r_tpu_torch, it exits
non-zero and prints no result.  Float32 convs run with TF32 off.  It writes
only the kernel build directory.
"""

import functools
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
# Published dense peaks of the H100 SXM by operand type: bfloat16 on the
# tensor cores, float32 outside them (TF32 is off here).
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
FULL_HW = (1024, 2048)
BATCH = 8
CHECK_HW = (513, 513)
TRAIN_HW = (512, 1024)      # bench.py's train crop
TRAIN_CHECK_HW = (128, 128)
LEAF_BOUND = 3e-2           # phase 4a, per leaf of G's gradient (float32)
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


def bound_ms(nbytes, flops, dtype):
    """The least time for moving `nbytes` and doing `flops` on operands of
    `dtype`, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
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


# Edge shapes (N, C, H, W, d) of the depthwise tile sweeps, phases 2a and
# 2c (the layouts each takes: tests/test_torch_port_depthwise_plan.py).
EDGE_SHAPES = [(2, 64, 5, 3, 1), (1, 16, 1, 1, 1), (1, 16, 1, 1, 3),
               (1, 24, 13, 11, 2), (1, 3, 5, 5, 2), (1, 960, 33, 33, 2),
               (2, 40, 9, 37, 4), (1, 256, 45, 90, 40), (2, 48, 12, 70, 2),
               (1, 144, 40, 200, 2), (2500, 16, 2, 3, 1)]


def slower(per_shape):
    """How many shapes of a per_shape list the kernel loses to its library
    call at."""
    return sum(r["ms"] > r["library_ms"] for r in per_shape)


def dk_check(dw, x, g, d):
    """dk kernel against its plain version (max|diff| <= 1e-4 * max|ref|)
    and bit-identical on a repeated call; returns (dk, ref, rel err)."""
    dk = dw.depthwise_dk(x, g, d)
    ref = dw.depthwise_dk_plain(x, g, d)
    require(torch.equal(dk, dw.depthwise_dk(x, g, d)),
            f"depthwise_dk {tuple(x.shape)} d={d} {x.dtype}: a repeated "
            "call differs")
    torch.cuda.synchronize()
    err = rel_err(dk, ref)
    require(dk.dtype == torch.float32 and err <= 1e-4,
            f"depthwise_dk {tuple(x.shape)} d={d} {x.dtype}: rel err {err}")
    return dk, ref, err


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
                               18 * x.numel(), dtype)
            per_shape[(n, c, h, w, d, dtype)] = (kern, plain, lib, bnd, by, err)
            log(f"[depthwise] {n} {c} {h} {w} {d} {str(dtype)[6:]}: {err:.3g} "
                f"| {kern:.4f} {plain:.4f} {lib:.4f} {bnd:.4f}")
            del x, k, xv
    # Edge shapes of the tile sweep (N, C, H, W, d, element offset): W and
    # H under one tile, H = W = 1, odd H at d = 2 (ROADMAP C.1's shapes),
    # d = 4, a halo wider than the tile (d = 40), tile boundaries inside a
    # dilation-2 halo, blocks that stream several images shorter than the
    # rows staged ahead (N = 2500), and the one-channel path: C off the
    # vector (7, 20) and an unaligned (but contiguous) input.
    edges = [(n, c, h, w, d, 0) for n, c, h, w, d in EDGE_SHAPES]
    edges += [(2, 7, 33, 65, 2, 0), (2, 20, 17, 19, 1, 0), (1, 24, 17, 19, 2, 1),
              (2, 7, 9, 37, 4, 1)]
    for n, c, h, w, d, offset in edges:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dtype, gen, offset)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            err = dw_check(dw, x, k, d)
            worst[dtype] = max(worst[dtype], err)
    log(f"[depthwise] {len(edges)} edge shapes pass (tiles, halos, C=7, C=20, "
        "unaligned input)")
    rows = [per_shape[(BATCH,) + s + (torch.bfloat16,)] for s in main]
    serve = [{"C": c, "H": h, "W": w, "d": d, "launches": main.count((c, h, w, d)),
              "ms": per_shape[(BATCH, c, h, w, d, torch.bfloat16)][0],
              "library_ms": per_shape[(BATCH, c, h, w, d, torch.bfloat16)][2],
              "bound_ms": per_shape[(BATCH, c, h, w, d, torch.bfloat16)][3]}
             for c, h, w, d in sorted(set(main))]
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
             "library_ms": sum(r[2] for r in rows),
             "ms_covers": "one 2048x1024 batch-8 bf16 serving forward: 14 "
                          "launches; by_path.train_step: one train step; "
                          "per_shape: ms, library_ms and bound_ms a launch",
             "per_shape": {"serve": serve},
             "slower_than_library": {"serve": slower(serve)}}
    log(f"[depthwise] all checks passed; worst max_abs_err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; one "
        f"2048x1024 batch-8 bf16 forward (14 launches): kernel "
        f"{entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, cuDNN "
        f"{entry['library_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms; "
        f"slower than cuDNN at {entry['slower_than_library']['serve']} of "
        f"{len(serve)} shapes")
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
        # int32 in, int8 out; the arithmetic is float32
        bnd, by = bound_ms(5 * x.numel() + 8 * shape[-1], 2 * x.numel(),
                           torch.float32)
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


def build_model(dtype, device):
    from s2r_tpu_torch.models.deeplab import DeepLab

    from s2r_tpu_torch.tools.step_conditioning import perturb_batchnorm

    model = DeepLab(num_classes=19, output_stride=16, dtype=dtype,
                    device=device,
                    generator=torch.Generator().manual_seed(SEED))
    perturb_batchnorm(model, SEED + 1)
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


def serve_full(counted):
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
    reset(counted)
    for fn in fns.values():
        fn(images)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"[serve 2048x1024] launches in one exact + one int8 call: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(depthwise_conv3x3=28, requant_s32_to_s8=1)
    require(launches == want, f"unexpected launch counts {launches}")
    return ms, launches


def rel_err(got, ref):
    """max|got - ref| / max|ref| in float64."""
    ref = ref.double()
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def check_depthwise_bwd(dw):
    """Phase 2c: the depthwise VJP at the train step's 14 layer shapes.  dx
    is the forward kernel on the cotangent with the taps flipped; dk is the
    dk kernel.  Returns (the depthwise_dk entry for one train step: 28
    launches, 2 per layer; the depthwise kernel's times on the train step:
    28 forward and 28 dx launches)."""
    import torch.nn.functional as F

    from s2r_tpu_torch.models.mobilenet import block_plan

    main = dw_shapes(TRAIN_HW, block_plan)
    require(len(main) == 14, f"expected 14 stride-1 depthwise convs, {main}")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    per_shape = {}
    log("[depthwise bwd] N C H W d dtype: dx err, dk rel err | dk kernel_ms "
        "plain_ms library_ms bound_ms | fwd+dx kernel_ms plain_ms "
        "library_ms bound_ms")
    for c, h, w, d in sorted(set(main)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((BATCH, h, w, c), dtype, gen)
            g = randn((BATCH, h, w, c), dtype, gen)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            kf = k.flip((0, 1)).contiguous()
            dx_err = dw_check(dw, g, kf, d)
            dk, dk_ref, dk_err = dk_check(dw, x, g, d)
            xv, gv = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            kern = cuda_ms(lambda: dw.depthwise_dk(x, g, d))
            plain = cuda_ms(lambda: dw.depthwise_dk_plain(x, g, d))
            lib = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                xv, (c, 1, 3, 3), gv, padding=d, dilation=d, groups=c))
            # forward on x and dx on g: the kernel's two launches a layer
            wt = k.permute(2, 0, 1).unsqueeze(1)
            wtf = kf.permute(2, 0, 1).unsqueeze(1)
            fx = [cuda_ms(lambda: dw.depthwise_conv3x3(x, k, d))
                  + cuda_ms(lambda: dw.depthwise_conv3x3(g, kf, d)),
                  cuda_ms(lambda: dw.depthwise_conv3x3_plain(x, k, d))
                  + cuda_ms(lambda: dw.depthwise_conv3x3_plain(g, kf, d)),
                  cuda_ms(lambda: F.conv2d(xv, wt, padding=d, dilation=d,
                                           groups=c))
                  + cuda_ms(lambda: F.conv2d(gv, wtf, padding=d, dilation=d,
                                             groups=c))]
            isz = x.element_size()
            bnd, by = bound_ms(2 * x.numel() * isz + 9 * c * 4,
                               18 * x.numel(), dtype)
            fx_bnd, fx_by = bound_ms(2 * (2 * x.numel() * isz + 9 * c * isz),
                                     2 * 18 * x.numel(), dtype)
            per_shape[(c, h, w, d, dtype)] = (kern, plain, lib, bnd, by,
                                              float((dk - dk_ref).abs().max()),
                                              fx, fx_bnd, fx_by, dx_err)
            log(f"[depthwise bwd] {BATCH} {c} {h} {w} {d} {str(dtype)[6:]}: "
                f"{dx_err:.3g}, {dk_err:.3g} | {kern:.4f} {plain:.4f} "
                f"{lib:.4f} {bnd:.4f} | {fx[0]:.4f} {fx[1]:.4f} {fx[2]:.4f} "
                f"{fx_bnd:.4f}")
            del x, g, xv, gv
    # the edge shapes of phase 2a, dk and dx, and dk on the one-channel
    # path (C off the vector, an unaligned input)
    edges = [(n, c, h, w, d, 0) for n, c, h, w, d in EDGE_SHAPES]
    edges += [(2, 7, 33, 65, 2, 0), (1, 24, 17, 19, 2, 1), (2, 7, 9, 37, 4, 1)]
    for n, c, h, w, d, offset in edges:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dtype, gen, offset)
            g = randn((n, h, w, c), dtype, gen, offset)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            dw_check(dw, g, k.flip((0, 1)).contiguous(), d)
            dk_check(dw, x, g, d)
    log(f"[depthwise bwd] {len(edges)} edge shapes pass (dx, and dk "
        "bit-identical on a repeated call)")
    rows = [per_shape[s + (torch.bfloat16,)] for s in main]
    # per launch: dk one a layer and image set; forward + dx two
    dk_rows, fx_rows = [], []
    for c, h, w, d in sorted(set(main)):
        r = per_shape[(c, h, w, d, torch.bfloat16)]
        mult = 2 * main.count((c, h, w, d))  # src and tgt
        dk_rows.append({"C": c, "H": h, "W": w, "d": d, "launches": mult,
                        "ms": r[0], "library_ms": r[2], "bound_ms": r[3]})
        fx_rows.append({"C": c, "H": h, "W": w, "d": d, "launches": 2 * mult,
                        "ms": r[6][0] / 2, "library_ms": r[6][2] / 2,
                        "bound_ms": r[7] / 2})
    entry = {"name": "depthwise_dk", "route": "cuda",
             "source": "s2r_tpu_torch/csrc/depthwise.cu",
             "replaces": "s2r_tpu/ops/pallas/depthwise.py:165",
             "launches": None,
             "max_abs_err": max(r[5] for r in rows),
             "ms": 2 * sum(r[0] for r in rows),
             "plain_ms": 2 * sum(r[1] for r in rows),
             "bound_ms": 2 * sum(r[3] for r in rows),
             "bound_by": "bytes" if all(r[4] == "bytes" for r in rows)
             else "operations",
             "library_ms": 2 * sum(r[2] for r in rows),
             "ms_covers": "one 512x1024 batch-8 bf16 train step: 14 layers "
                          "x (src, tgt) = 28 launches; per_shape: ms, "
                          "library_ms and bound_ms a launch",
             "per_shape": {"train_step": dk_rows},
             "slower_than_library": {"train_step": slower(dk_rows)}}
    train = {"ms": 2 * sum(r[6][0] for r in rows),
             "plain_ms": 2 * sum(r[6][1] for r in rows),
             "library_ms": 2 * sum(r[6][2] for r in rows),
             "bound_ms": 2 * sum(r[7] for r in rows),
             "bound_by": "bytes" if all(r[8] == "bytes" for r in rows)
             else "operations",
             "max_abs_err": max(r[9] for r in rows),
             "ms_covers": "one 512x1024 batch-8 bf16 train step: 14 layers "
                          "x (src, tgt) x (forward, dx) = 56 launches",
             "per_shape": fx_rows, "slower_than_library": slower(fx_rows)}
    log(f"[depthwise bwd] all checks passed; one train step (bf16): dk (28 "
        f"launches) kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.3f}, cuDNN weight grad "
        f"{entry['library_ms']:.3f}, bound {entry['bound_ms']:.3f}; forward "
        f"+ dx (56 launches) kernel {train['ms']:.3f} ms, plain "
        f"{train['plain_ms']:.3f}, cuDNN {train['library_ms']:.3f}, bound "
        f"{train['bound_ms']:.3f}; slower than cuDNN at "
        f"{entry['slower_than_library']['train_step']} (dk) and "
        f"{train['slower_than_library']} (forward + dx) of {len(dk_rows)} "
        "shapes")
    return entry, train


def bn_input_shapes():
    """(C, H, W) of every train-mode BatchNorm input of one 512x1024 batch-8
    forward, in call order, read by hooks on a throwaway model."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.models.layers import BatchNorm

    model = DeepLab(dtype="bf16", device=DEV,
                    generator=torch.Generator().manual_seed(SEED))
    model.train()
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape[1:])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(torch.zeros((BATCH, 3) + TRAIN_HW, device=DEV))
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return shapes


def bn_rel(got, ref):
    """max|got - ref| / max|ref| per row of [rows, C] results, in float64."""
    got, ref = got.double(), ref.double()
    return [float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
            for g, r in zip(got.reshape(len(got), -1), ref.reshape(len(ref), -1))]


def check_batchnorm(bn):
    """Phase 2d: the four BatchNorm entries at every train-mode BatchNorm
    input shape of one 512x1024 batch-8 forward, bfloat16 and float32: the
    statistics (with the running statistics), y, the backward sums (with a
    cotangent of shift) and dx, each against its plain version on the same
    inputs, and each bit-identical on a repeated call.  Times (bf16): each
    entry, its plain version and its one-call PyTorch counterpart; the
    composite (all four, as one BatchNorm's forward and backward) against
    native_batch_norm + native_batch_norm_backward.  Returns the four
    entries for one train step (60 BNs x (src, tgt) = 120 calls each) and
    the composite's row."""
    from collections import Counter

    shapes = bn_input_shapes()
    require(len(shapes) == 60, f"expected 60 BatchNorms, got {len(shapes)}")
    counts = Counter(shapes)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    names = ("batch_norm_stats", "batch_norm_apply", "batch_norm_grad_sums",
             "batch_norm_dx")
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "max_abs_err": 0.0} for k in names}
    comp = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    sums_lib = 0.0
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    eps, mom = 1e-5, 0.1
    log("[batchnorm] N C H W x count: worst rel err f32, bf16 | bf16 ms "
        "kernel/plain/library: stats, apply, grad_sums, dx | composite "
        "kernel plain native bound")
    for (c, h, w), mult in sorted(counts.items()):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 1e-4
            x4 = randn((BATCH, h, w, c), dtype, gen).permute(0, 3, 1, 2)
            g4 = randn((BATCH, h, w, c), dtype, gen).permute(0, 3, 1, 2)
            x = x4.permute(0, 2, 3, 1).reshape(-1, c)
            g = g4.permute(0, 2, 3, 1).reshape(-1, c)
            weight = 1 + 0.1 * torch.randn(c, device=DEV, generator=gen)
            bias = 0.1 * torch.randn(c, device=DEV, generator=gen)
            gshift = torch.randn(c, device=DEV, generator=gen)
            rm0 = 0.1 * torch.randn(c, device=DEV, generator=gen)
            rv0 = 0.5 + torch.rand(c, device=DEV, generator=gen)
            count = BATCH * (h + 2) * (w + 2)   # the ring's count
            rm, rv = rm0.clone(), rv0.clone()
            rm_p, rv_p = rm0.clone(), rv0.clone()
            st = bn.batch_norm_stats(x, weight, bias, count, eps, rm, rv, mom)
            st_p = bn.batch_norm_stats_plain(x, weight, bias, count, eps,
                                             rm_p, rv_p, mom)
            inv, shift = st[bn.INV], st[bn.SHIFT]
            gr = bn.batch_norm_grad_sums(g, x, st, gshift, count)
            coef = (gr[bn.COEF_B], gr[bn.COEF_C0])
            # each entry's inputs; the plain versions get the kernels'
            # statistics, so each kernel is held against its own function
            args = {"batch_norm_stats": (x, weight, bias, count, eps, rm, rv,
                                         mom),
                    "batch_norm_apply": (x, inv, shift),
                    "batch_norm_grad_sums": (g, x, st, gshift, count),
                    "batch_norm_dx": (g, x, inv, *coef)}
            y = bn.batch_norm_apply(*args["batch_norm_apply"])
            y_p = bn.batch_norm_apply_plain(*args["batch_norm_apply"])
            gr_p = bn.batch_norm_grad_sums_plain(*args["batch_norm_grad_sums"])
            dx = bn.batch_norm_dx(*args["batch_norm_dx"])
            dx_p = bn.batch_norm_dx_plain(*args["batch_norm_dx"])
            again = (bn.batch_norm_stats(x, weight, bias, count, eps),
                     bn.batch_norm_apply(*args["batch_norm_apply"]),
                     bn.batch_norm_grad_sums(*args["batch_norm_grad_sums"]),
                     bn.batch_norm_dx(*args["batch_norm_dx"]))
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in
                        zip(again, (st, y, gr, dx))),
                    f"batchnorm {(BATCH, c, h, w)} {dtype}: a repeated call "
                    "differs")
            require(y.dtype == dx.dtype == dtype
                    and st.dtype == gr.dtype == torch.float32,
                    f"batchnorm {(BATCH, c, h, w)} {dtype}: output types")
            e = {"stats": max(bn_rel(st, st_p)),
                 "running": max(bn_rel(torch.stack([rm, rv]),
                                       torch.stack([rm_p, rv_p]))),
                 "apply": max(bn_rel(y.view(1, -1), y_p.view(1, -1))),
                 "grad_sums": max(bn_rel(gr, gr_p)),
                 "dx": max(bn_rel(dx.view(1, -1), dx_p.view(1, -1)))}
            require(max(e.values()) <= tol, f"batchnorm {(BATCH, c, h, w)} "
                    f"{dtype}: rel errs {e} > {tol}")
            errs[dtype] = max(e.values())
            worst[dtype] = max(worst[dtype], errs[dtype])
            if dtype != torch.bfloat16:
                del x4, g4, x, g, y, y_p, dx, dx_p, again, args
                continue
            abs_err = dict(zip(names, (
                float((u.float() - v.float()).abs().max())
                for u, v in ((st, st_p), (y, y_p), (gr, gr_p), (dx, dx_p)))))
            mean, invstd = st[bn.MEAN], st[bn.RSTD]
            cnt = torch.full((1,), count, dtype=torch.int32, device=DEV)
            library = {
                "batch_norm_stats": lambda: torch.batch_norm_stats(x4, eps),
                "batch_norm_apply": lambda: torch.batch_norm_elemt(
                    x4, weight, bias, mean, invstd, eps),
                "batch_norm_grad_sums":
                    lambda: torch.batch_norm_backward_reduce(
                        g4, x4, mean, invstd, weight, True, True, True),
                "batch_norm_dx": lambda: torch.batch_norm_backward_elemt(
                    g4, x4, mean, invstd, weight, gr[bn.SUM_G],
                    gr[bn.SUM_GX], cnt)}
            t = {name: (functools.partial(getattr(bn, name), *args[name]),
                        functools.partial(getattr(bn, name + "_plain"),
                                          *args[name]),
                        library[name]) for name in names}
            isz = x.element_size()
            mc = x.numel()
            # bytes (each input read once, each output written once) and
            # flops of each entry; per-channel vectors are float32
            work = {"batch_norm_stats": (mc * isz + 4 * 4 * c + 9 * 4 * c,
                                         3 * mc),
                    "batch_norm_apply": (2 * mc * isz + 8 * c, 2 * mc),
                    "batch_norm_grad_sums": (2 * mc * isz + 40 * c, 3 * mc),
                    "batch_norm_dx": (3 * mc * isz + 12 * c, 4 * mc)}
            row = []
            k = 2 * mult  # src and tgt
            for name, fns in t.items():
                ms = [cuda_ms(f) for f in fns]
                # float32 math on the CUDA cores: the float32 peak
                bnd, _ = bound_ms(*work[name], torch.float32)
                tot = totals[name]
                tot["ms"] += k * ms[0]
                tot["plain_ms"] += k * ms[1]
                tot["library_ms"] += k * ms[2]
                tot["bound_ms"] += k * bnd
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err[name])
                row.append("/".join(f"{v:.4f}" for v in ms))
            sums_lib += k * (cuda_ms(library["batch_norm_stats"])
                             + cuda_ms(lambda: torch.batch_norm_backward_reduce(
                                 g4, x4, mean, invstd, weight, True, False,
                                 False)))

            def composite(stats, apply, grad_sums, dxf, rm_, rv_):
                s_ = stats(x, weight, bias, count, eps, rm_, rv_, mom)
                apply(x, s_[bn.INV], s_[bn.SHIFT])
                r_ = grad_sums(g, x, s_, gshift, count)
                dxf(g, x, s_[bn.INV], r_[bn.COEF_B], r_[bn.COEF_C0])

            def native():
                out = torch.ops.aten.native_batch_norm(
                    x4, weight, bias, rm_p, rv_p, True, mom, eps)
                torch.ops.aten.native_batch_norm_backward(
                    g4, x4, weight, rm_p, rv_p, out[1], out[2], True, eps,
                    [True, True, True])

            cm = [cuda_ms(lambda: composite(
                      bn.batch_norm_stats, bn.batch_norm_apply,
                      bn.batch_norm_grad_sums, bn.batch_norm_dx, rm, rv)),
                  cuda_ms(lambda: composite(
                      bn.batch_norm_stats_plain, bn.batch_norm_apply_plain,
                      bn.batch_norm_grad_sums_plain, bn.batch_norm_dx_plain,
                      rm_p, rv_p)),
                  cuda_ms(native)]
            # x and g read once, y and dx written once
            cb, _ = bound_ms(4 * mc * isz + 56 * c, 12 * mc, torch.float32)
            for key, v in zip(("ms", "plain_ms", "library_ms"), cm):
                comp[key] += k * v
            comp["bound_ms"] += k * cb
            log(f"[batchnorm] {BATCH} {c} {h} {w} x{mult}: "
                f"{errs[torch.float32]:.3g}, {errs[torch.bfloat16]:.3g} | "
                f"{' '.join(row)} | {cm[0]:.4f} {cm[1]:.4f} {cm[2]:.4f} "
                f"{cb:.4f}")
            del x4, g4, x, g, y, y_p, dx, dx_p, again, args, t, library
    entries = []
    for name in names:
        tot = totals[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "s2r_tpu_torch/csrc/batchnorm.cu",
            "replaces": ("s2r_tpu/ops/pallas/batchnorm.py:77"
                         if name in ("batch_norm_stats", "batch_norm_grad_sums")
                         else "s2r_tpu/ops/pallas/batchnorm.py:111"),
            "launches": None, "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"],
            "ms_covers": "one 512x1024 batch-8 bf16 train step: 60 "
                         "BatchNorms x (src, tgt) = 120 calls"})
    composite_row = dict(comp, sums_ms=totals["batch_norm_stats"]["ms"]
                         + totals["batch_norm_grad_sums"]["ms"],
                         sums_library_ms=sums_lib)
    log(f"[batchnorm] all checks passed; worst rel err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; one "
        f"train step (bf16, 120 BatchNorm calls): sums (stats + grad_sums) "
        f"{composite_row['sums_ms']:.3f} ms against batch_norm_stats + "
        f"backward_reduce {sums_lib:.3f}; composite {comp['ms']:.3f} ms, "
        f"plain {comp['plain_ms']:.3f}, native_batch_norm + backward "
        f"{comp['library_ms']:.3f}, bound {comp['bound_ms']:.3f}; "
        + "; ".join(f"{n} {totals[n]['ms']:.3f} (plain "
                    f"{totals[n]['plain_ms']:.3f}, library "
                    f"{totals[n]['library_ms']:.3f}, bound "
                    f"{totals[n]['bound_ms']:.3f})" for n in names))
    return entries, composite_row


def disc_check(dc, x, k, b):
    """disc_conv1 against its plain version; returns (output, max_abs_err)
    or raises.  Tolerances as the depthwise forward's."""
    got = dc.disc_conv1(x, k, b)
    ref = dc.disc_conv1_plain(x, k, b)
    torch.cuda.synchronize()
    n, h, c, w = x.shape
    require(got.shape == (n, h // 2, w // 2, k.shape[3])
            and got.dtype == x.dtype and got.is_contiguous(),
            f"disc_conv1 output {tuple(got.shape)} {got.dtype}")
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().clamp(min=1.0)
    if x.dtype == torch.float32:
        ok = float(diff.max()) <= 1e-5 * float(scale.max())
    else:
        ok = bool((diff <= 1e-2 * scale).all())
    err = float(diff.max())
    require(ok, f"disc_conv1 {tuple(x.shape)} {x.dtype}: max_abs_err {err}")
    return got, err


def disc_inputs(n, c, h, w, ndf, dtype, gen, nchw=True):
    """A softmax map as the step makes it (NCHW, seen as [N,H,C,W]; or a
    contiguous [N,H,C,W] tensor), an HWIO kernel and a bias."""
    logits = torch.randn((n, c, h, w), device=DEV, generator=gen)
    x_nchw = torch.softmax(logits, dim=0).to(dtype)
    del logits
    x = x_nchw.permute(0, 2, 1, 3)
    if not nchw:
        x = x.contiguous()
    k = (torch.rand((4, 4, c, ndf), device=DEV, generator=gen) * 2 - 1
         ).mul_(1 / (16 * c) ** 0.5).to(dtype)
    b = (torch.rand((ndf,), device=DEV, generator=gen) * 0.2 - 0.1).to(dtype)
    return x_nchw, x, k, b


def check_disc_conv1(dc):
    """Phase 2e: disc_conv1 at the step's shape, 8x19x512x1024 (the NCHW
    softmax map seen as [N,H,C,W]) -> 8x256x512x64: bfloat16 on the tensor
    cores and float32 on the CUDA cores; then bfloat16 at edge shapes (a
    width off the 16-byte grid, a partial column strip and an odd number of
    output rows; three input channels).  Returns the bf16 entry for one
    train step (3 launches), with the f32 row beside it."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    n, c, (h, w), ndf = BATCH, 19, TRAIN_HW, 64
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x_nchw, x, k, b = disc_inputs(n, c, h, w, ndf, dtype, gen)
        got, err = disc_check(dc, x, k, b)
        w_oihw = k.permute(3, 2, 0, 1).contiguous()
        kern = cuda_ms(lambda: dc.disc_conv1(x, k, b))
        plain = cuda_ms(lambda: dc.disc_conv1_plain(x, k, b))
        lib = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, b, stride=2,
                                       padding=1))
        isz = x.element_size()
        nbytes = (x.numel() + got.numel() + k.numel() + ndf) * isz
        flops = 2 * got.numel() * 16 * c
        bnd, by = bound_ms(nbytes, flops, dtype)
        rows[dtype] = {"ms": kern, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        log(f"[disc_conv1] {str(dtype)[6:]} "
            f"({'tensor cores' if dtype == torch.bfloat16 else 'CUDA cores'})"
            f": max_abs_err {err:.3g} | kernel {kern:.4f} ms, plain "
            f"{plain:.4f}, F.conv2d {lib:.4f}, bound {bnd:.4f} ({by}; bytes "
            f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms for {nbytes / 1e6:.1f} "
            f"MB, {flops / 1e9:.1f} GFLOP at the {str(dtype)[6:]} peak "
            f"{1e3 * flops / PEAK_FLOP_PER_S[dtype]:.4f} ms)")
        del x_nchw, x, got
    for (en, ec, eh, ew), nchw in (((2, 19, 18, 1030), False),
                                   ((1, 3, 22, 256), True),
                                   ((3, 19, 6, 300), True)):
        _, x, k, b = disc_inputs(en, ec, eh, ew, ndf, torch.bfloat16, gen,
                                 nchw)
        disc_check(dc, x, k, b)
    log("[disc_conv1] bf16 edge shapes (W=1030 staged element by element, "
        "C=3, 3 output rows, partial strips) pass")
    r = rows[torch.bfloat16]
    f32 = {key: 3 * v if key.endswith("ms") else v
           for key, v in rows[torch.float32].items()}
    return {"name": "disc_conv1", "route": "cuda",
            "source": "s2r_tpu_torch/csrc/disc_conv.cu",
            "replaces": "s2r_tpu/ops/pallas/disc_conv.py:174",
            "launches": None, "max_abs_err": r["max_abs_err"],
            "ms": 3 * r["ms"], "plain_ms": 3 * r["plain_ms"],
            "bound_ms": 3 * r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": 3 * r["library_ms"], "float32": f32,
            "ms_covers": "one 512x1024 batch-8 bf16 train step: D's three "
                         "forwards = 3 launches (bf16, tensor cores); "
                         "float32: the CUDA-core kernel at the same shape"}


def check_index_limits(dw, rq, dc):
    """Phase 2f: each kernel that indexed in 32 bits on one input just over
    2^31 elements: the depthwise forward and requant split the batch (two
    launches), dk and disc_conv1 index in 64 bits (one launch).  Each is
    compared with its plain version on the batch items at each side of the
    split, or of element 2^31, and on the last."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    lim = 2 ** 31

    # depthwise bf16 [114, 256, 512, 144]: 113 images a launch
    x = randn((114, 256, 512, 144), torch.bfloat16, gen)
    k = (randn((3, 3, 144), torch.float32, gen) / 3).to(torch.bfloat16)
    require(x.numel() >= lim, "depthwise input under 2^31")
    before = dw.depthwise_conv3x3.launches
    y = dw.depthwise_conv3x3(x, k, 1)
    torch.cuda.synchronize()
    made = dw.depthwise_conv3x3.launches - before
    require(made == 2, f"depthwise over 2^31: {made} launches, not 2")
    for i in (112, 113):
        ref = dw.depthwise_conv3x3_plain(x[i:i + 1], k, 1)
        diff = (y[i:i + 1].float() - ref.float()).abs()
        require(bool((diff <= 1e-2 * ref.float().abs().clamp(min=1.0)).all()),
                f"depthwise over 2^31, image {i}: max_abs_err "
                f"{float(diff.max())}")
    del y
    # dk on the same x and a cotangent: one launch; the plain version
    # summed over runs of 16 images in float64
    g = randn((114, 256, 512, 144), torch.bfloat16, gen)
    before = dw.depthwise_dk.launches
    dk = dw.depthwise_dk(x, g, 1)
    torch.cuda.synchronize()
    require(dw.depthwise_dk.launches - before == 1, "dk over 2^31: launches")
    ref = sum(dw.depthwise_dk_plain(x[a:a + 16], g[a:a + 16], 1).double()
              for a in range(0, 114, 16))
    dk_err = rel_err(dk, ref)
    require(dk_err <= 1e-4, f"dk over 2^31: rel err {dk_err}")
    log(f"[limits] depthwise bf16 {tuple(x.shape)} ({x.numel()} elements): "
        f"2 launches, images 112 and 113 match; dk 1 launch, rel err "
        f"{dk_err:.3g}")
    del x, g, dk, ref

    # requant int32 [65, 256, 512, 256]: rows split at (2^31 - 1) // 256
    xq, m, b = requant_inputs((65, 256, 512, 256), gen)
    require(xq.numel() >= lim, "requant input under 2^31")
    before = rq.requant_s32_to_s8.launches
    yq = rq.requant_s32_to_s8(xq, m, b)
    torch.cuda.synchronize()
    made = rq.requant_s32_to_s8.launches - before
    require(made == 2, f"requant over 2^31: {made} launches, not 2")
    for i in (63, 64):  # the split row lies in image 63; 64 is the last
        require(torch.equal(yq[i], rq.requant_plain(xq[i], m, b)),
                f"requant over 2^31, image {i}: not bit-exact")
    log(f"[limits] requant int32 {tuple(xq.shape)} ({xq.numel()} elements): "
        "2 launches, images 63 and 64 bit-exact")
    del xq, yq

    # disc_conv1 at batch 256 of 512x1024 bf16: input element 2^31 lies in
    # image 215, the output has exactly 2^31 elements
    _, xd, kd, bd = disc_inputs(256, 19, 512, 1024, 64, torch.bfloat16, gen)
    before = dc.disc_conv1.launches
    yd = dc.disc_conv1(xd, kd, bd)
    torch.cuda.synchronize()
    require(dc.disc_conv1.launches - before == 1, "disc_conv1: launches")
    require(yd.numel() >= lim, "disc_conv1 output under 2^31")
    worst = 0.0
    for i in (215, 216, 255):
        ref = dc.disc_conv1_plain(xd[i:i + 1], kd, bd)
        diff = (yd[i:i + 1].float() - ref.float()).abs()
        require(bool((diff <= 1e-2 * ref.float().abs().clamp(min=1.0)).all()),
                f"disc_conv1 at batch 256, image {i}: max_abs_err "
                f"{float(diff.max())}")
        worst = max(worst, float(diff.max()))
    log(f"[limits] disc_conv1 bf16 batch 256 ({xd.numel()} input, "
        f"{yd.numel()} output elements): 1 launch, images 215, 216, 255 "
        f"match (max_abs_err {worst:.3g})")
    del xd, yd


def train_method(precision, device, affine=False):
    """build_method for the output-space adaptation step, weights from seed
    SEED, BatchNorm statistics perturbed as in phase 3 (and the BatchNorm
    scale and bias, if `affine`: perturb_batchnorm says why)."""
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.tools.step_conditioning import perturb_batchnorm
    from s2r_tpu_torch.train.setup import build_method

    method = build_method(Config(precision=precision), iters_per_epoch=1000,
                          device=device,
                          generator=torch.Generator().manual_seed(SEED))
    perturb_batchnorm(method.deeplab, SEED + 1, SEED + 2 if affine else None)
    return method


def snapshot(method):
    """(G params, D params, G running stats) as float64 CPU tensors."""
    g = {k: v.detach().double().cpu() for k, v in
         method.deeplab.named_parameters()}
    d = {k: v.detach().double().cpu() for k, v in
         method.aux_model.named_parameters()}
    s = {k: v.detach().double().cpu() for k, v in
         method.deeplab.named_buffers() if k.endswith(("_mean", "_var"))}
    return g, d, s


def train_check_small(counted):
    """Phase 4a: one 128x128 batch-2 float32 step on the card against the CPU
    (float32 and the float64 reference), dropout off, from weights with
    the BatchNorm scale and bias perturbed (perturb_batchnorm says why)."""
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.models.layers import set_dropout
    from s2r_tpu_torch.tools.step_conditioning import sgd_gradients

    rs = np.random.RandomState(SEED)
    n, (h, w) = 2, TRAIN_CHECK_HW
    label = rs.randint(0, 19, (n, h, w)).astype(np.int64)
    label[:, :3] = 255
    batch = {"src_image": rs.randn(n, h, w, 3).astype(np.float32),
             "src_label": label,
             "tgt_image": rs.randn(n, h, w, 3).astype(np.float32)}
    wd = Config().weight_decay
    runs = {}
    for name, device, precision in (("card", DEV, "f32"), ("cpu", "cpu", "f32"),
                                    ("exact", "cpu", "f64")):
        method = train_method(precision, device, affine=True)
        set_dropout(method.deeplab, False)
        state = method.init_state()
        before = snapshot(method)
        reset(counted)
        state, metrics = method.step_fn(state, batch)
        if name == "card":
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counted}
        runs[name] = ({k: float(v) for k, v in metrics.items()}, before,
                      snapshot(method),
                      sgd_gradients(state.opt_state["G"]["momentum"],
                                    before[0], wd))
        del method, state
    log(f"[train {h}x{w}] launches in the card's step: {launches}")
    require(all(v > 0 for k, v in launches.items()
                if k != "requant_s32_to_s8"),
            f"{h}x{w} step missed a kernel: {launches}")
    (m_card, b_card, a_card, gr_card), (m_cpu, b_cpu, a_cpu, gr_cpu), \
        (_, b_ex, a_ex, gr_ex) = runs["card"], runs["cpu"], runs["exact"]
    for k in ("seg_loss", "adv_loss", "d_loss"):
        err = abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
        require(np.isfinite(m_card[k]) and err <= 1e-4,
                f"{h}x{w} {k}: card {m_card[k]} cpu {m_cpu[k]}")
    stats_err = max(float((a_card[2][k] - a_cpu[2][k]).abs().max()
                          / a_cpu[2][k].abs().max()) for k in a_cpu[2])
    require(stats_err <= 1e-3, f"{h}x{w} BN running stats: {stats_err}")

    def upd(before, after, i):
        return torch.cat([(after[i][k] - before[i][k]).reshape(-1)
                          for k in sorted(before[i])])

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    # G, per leaf: the card's gradient against the float64 one, within
    # LEAF_BOUND or 3x the CPU's own float32 distance from it for that
    # leaf, whichever is larger.  Leaves the float64 run leaves unresolved
    # (gradient zero up to rounding) are left out.
    kept = [k for k in gr_ex if gr_ex[k] is not None]
    leaf = {k: (rel(gr_card[k], gr_ex[k]), rel(gr_cpu[k], gr_ex[k]))
            for k in kept}
    bad = {k: v for k, v in leaf.items()
           if v[0] > max(LEAF_BOUND, 3 * v[1])}
    worst = max(leaf, key=lambda k: leaf[k][0])
    worst_cpu = max(leaf, key=lambda k: leaf[k][1])
    g_card, g_cpu, g_ex = (torch.cat([g[k].reshape(-1) for k in kept])
                           for g in (gr_card, gr_cpu, gr_ex))
    d_card, d_cpu = upd(b_card, a_card, 1), upd(b_cpu, a_cpu, 1)
    sign = float((torch.sign(d_card) == torch.sign(d_cpu)).double().mean())
    log(f"[train {h}x{w}] losses card {m_card} vs cpu {m_cpu}; BN running "
        f"stats rel err {stats_err:.3g}; G gradient, {len(kept)} of "
        f"{len(gr_ex)} leaves resolved: worst leaf card-exact "
        f"{leaf[worst][0]:.3g} ({worst}; cpu-exact {leaf[worst][1]:.3g}), "
        f"worst leaf cpu-exact {leaf[worst_cpu][1]:.3g} ({worst_cpu}), "
        f"median leaf card-exact "
        f"{statistics.median(v[0] for v in leaf.values()):.3g}; global "
        f"card-exact {rel(g_card, g_ex):.3g}, cpu-exact "
        f"{rel(g_cpu, g_ex):.3g}, card-cpu {rel(g_card, g_cpu):.3g}; D "
        f"update sign agreement card-cpu {100 * sign:.3f}%")
    require(not bad, f"{h}x{w} G gradient: leaves off the float64 run {bad}")
    require(sign >= 0.99, f"{h}x{w} D update sign agreement {sign}")


def train_full(counted):
    """Phase 4b: the 512x1024 batch-8 bf16 step, timed; then the launch
    counts of one step."""
    method = train_method("bf16", DEV)
    state = method.init_state()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    batch = {"src_image": torch.randn((BATCH,) + TRAIN_HW + (3,), device=DEV,
                                      generator=gen),
             "src_label": torch.randint(0, 19, (BATCH,) + TRAIN_HW,
                                        device=DEV, generator=gen),
             "tgt_image": torch.randn((BATCH,) + TRAIN_HW + (3,), device=DEV,
                                      generator=gen)}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, metrics = method.step_fn(state, batch)
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = method.step_fn(state, batch)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = {k: float(v) for k, v in metrics.items()}
    require(all(np.isfinite(v) for v in losses.values()),
            f"512x1024 losses not finite: {losses}")
    ms = statistics.median(runs)
    log(f"[train 512x1024] {ms:.3f} ms/step (median of 5 batch-{BATCH} "
        f"bf16 steps: {', '.join(f'{r:.3f}' for r in runs)}), "
        f"{BATCH * 1e3 / ms:.2f} source images/s (bench.py's '1024x512 "
        f"train images/sec/chip (output-space adaption)'), peak device "
        f"memory {peak:.2f} GiB; losses after {state.step} steps {losses}")

    # The main-path run that the kernels line counts: one step.
    from s2r_tpu_torch.ops.kernels.batchnorm import channels_last_rows

    reset(counted)
    channels_last_rows.copies = 0
    state, metrics = method.step_fn(state, batch)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    copies = channels_last_rows.copies
    log(f"[train 512x1024] launches in one step: {launches}; BatchNorm "
        f"layout copies (an NCHW tensor made channels-last for the kernels):"
        f" {copies}")
    require(launches == {"depthwise_conv3x3": 56, "requant_s32_to_s8": 0,
                         "depthwise_dk": 28, "batch_norm_stats": 120,
                         "batch_norm_apply": 120, "batch_norm_grad_sums": 120,
                         "batch_norm_dx": 120, "disc_conv1": 3},
            f"unexpected launch counts {launches}")
    return ms, launches, copies


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from s2r_tpu_torch.ops.kernels import batchnorm as bn
        from s2r_tpu_torch.ops.kernels import build
        from s2r_tpu_torch.ops.kernels import depthwise as dw
        from s2r_tpu_torch.ops.kernels import disc_conv as dc
        from s2r_tpu_torch.ops.kernels import requant as rq
    except ImportError as e:
        print(f"chip_smoke: s2r_tpu_torch not found beside {__file__}: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counted = (dw.depthwise_conv3x3, rq.requant_s32_to_s8, dw.depthwise_dk,
               bn.batch_norm_stats, bn.batch_norm_apply,
               bn.batch_norm_grad_sums, bn.batch_norm_dx, dc.disc_conv1)
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        libs = build.build_all()
        log(f"[build] {len(libs)} kernels built with nvcc "
            f"({' '.join(build.NVCC_FLAGS)}) in {time.perf_counter() - t0:.1f} s")
        smi = card()
        log(f"[card] {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        dw_entry = check_depthwise(dw)
        kernels = [dw_entry, check_requant(rq)]
        dk_entry, dw_train = check_depthwise_bwd(dw)
        bn_entries, bn_composite = check_batchnorm(bn)
        kernels += [dk_entry, *bn_entries, check_disc_conv1(dc)]
        torch.cuda.empty_cache()
        check_index_limits(dw, rq, dc)
        torch.cuda.empty_cache()
        serve_check_513(dw, rq)
        torch.cuda.empty_cache()
        ms, serve_launches = serve_full(counted)
        torch.cuda.empty_cache()
        train_check_small(counted)
        torch.cuda.empty_cache()
        step_ms, train_launches, bn_copies = train_full(counted)
        bn_entries[0]["composite"] = dict(
            bn_composite, ms_covers="one 512x1024 batch-8 bf16 train step: "
            "all four entries of 120 BatchNorm calls; library_ms: "
            "native_batch_norm + native_batch_norm_backward; sums_ms: "
            "batch_norm_stats + batch_norm_grad_sums against "
            "sums_library_ms: torch.batch_norm_stats + "
            "batch_norm_backward_reduce")
        bn_entries[2]["layout_copies_per_step"] = bn_copies
        for k in kernels:
            paths = {"serve": serve_launches[k["name"]],
                     "train_step": train_launches[k["name"]]}
            k["launches"] = paths["serve"] + paths["train_step"]
            k["launches_by_path"] = paths
        dw_entry["per_shape"]["train_step"] = dw_train.pop("per_shape")
        dw_entry["slower_than_library"]["train_step"] = dw_train.pop(
            "slower_than_library")
        dw_entry["by_path"] = {
            "serve": {key: dw_entry[key] for key in
                      ("ms", "plain_ms", "bound_ms", "library_ms")},
            "train_step": dw_train}
    except (Failed, RuntimeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    log(f"[done] ms/image exact {ms['exact']:.3f}, decoder-int8 "
        f"{ms['decoder_int8']:.3f} (bf16, rgb8 {FULL_HW[1]}x{FULL_HW[0]} "
        f"batch {BATCH}); train step {step_ms:.3f} ms ({TRAIN_HW[1]}x"
        f"{TRAIN_HW[0]} batch {BATCH} bf16) on {smi}; "
        f"{time.perf_counter() - t_start:.1f} s after imports")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
