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
   1e-4 * max|ref| (a reduction over ~1e7 terms in another order);
   pair_sums float32 1e-5 * max|ref|, bfloat16 inputs 1e-4 * max|ref|;
   disc_conv1 as the depthwise forward; requant bit-exact; pair_sums and
   dk, which fold in a fixed order, bit-identical on a repeated call.
   bound_ms is the larger of the bytes over 3.35 TB/s and the flops over
   the published peak for the operand type (bfloat16 989 TFLOP/s on the
   tensor cores, float32 67 TFLOP/s).
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
   and the launch counts of one step.
5. Print the kernels line, the card's name and power limit, and as the last
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
             "library_ms": sum(r[2] for r in rows),
             "ms_covers": "one 2048x1024 batch-8 bf16 serving forward: 14 "
                          "launches; by_path.train_step: one train step"}
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
    require(launches == {"depthwise_conv3x3": 28, "requant_s32_to_s8": 1,
                         "depthwise_dk": 0, "pair_sums": 0, "disc_conv1": 0},
            f"unexpected launch counts {launches}")
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
            dk = dw.depthwise_dk(x, g, d)
            dk_ref = dw.depthwise_dk_plain(x, g, d)
            require(torch.equal(dk, dw.depthwise_dk(x, g, d)),
                    f"depthwise_dk {(BATCH, h, w, c)} d={d} {dtype}: a "
                    "repeated call differs")
            torch.cuda.synchronize()
            dk_err = rel_err(dk, dk_ref)
            require(dk.dtype == torch.float32 and dk_err <= 1e-4,
                    f"depthwise_dk {(BATCH, h, w, c)} d={d} {dtype}: "
                    f"rel err {dk_err}")
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
    rows = [per_shape[s + (torch.bfloat16,)] for s in main]
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
                          "x (src, tgt) = 28 launches"}
    train = {"ms": 2 * sum(r[6][0] for r in rows),
             "plain_ms": 2 * sum(r[6][1] for r in rows),
             "library_ms": 2 * sum(r[6][2] for r in rows),
             "bound_ms": 2 * sum(r[7] for r in rows),
             "bound_by": "bytes" if all(r[8] == "bytes" for r in rows)
             else "operations",
             "max_abs_err": max(r[9] for r in rows),
             "ms_covers": "one 512x1024 batch-8 bf16 train step: 14 layers "
                          "x (src, tgt) x (forward, dx) = 56 launches"}
    log(f"[depthwise bwd] all checks passed; one train step (bf16): dk (28 "
        f"launches) kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.3f}, cuDNN weight grad "
        f"{entry['library_ms']:.3f}, bound {entry['bound_ms']:.3f}; forward "
        f"+ dx (56 launches) kernel {train['ms']:.3f} ms, plain "
        f"{train['plain_ms']:.3f}, cuDNN {train['library_ms']:.3f}, bound "
        f"{train['bound_ms']:.3f}")
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


def check_pair_sums(bn):
    """Phase 2d: pair_sums at every train-mode BatchNorm input shape of one
    512x1024 batch-8 forward, bf16, and float32 at three of them; forward
    statistics pair_sums(x, x) and backward sums pair_sums(g, x).  Returns
    the entry for one train step: 60 BNs x (src, tgt) x (fwd, bwd) = 240
    launches."""
    from collections import Counter

    shapes = bn_input_shapes()
    require(len(shapes) == 60, f"expected 60 BatchNorms, got {len(shapes)}")
    counts = Counter(shapes)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    max_abs = 0.0
    by_ops = False
    log("[pair_sums] N C H W dtype x count: rel err fwd, bwd | fwd kernel "
        "plain library bound | bwd kernel plain library bound (ms)")
    for i, ((c, h, w), mult) in enumerate(sorted(counts.items())):
        dtypes = (torch.bfloat16, torch.float32) if i < 3 else (torch.bfloat16,)
        for dtype in dtypes:
            m = BATCH * h * w
            x = randn((m, c), dtype, gen)
            g = randn((m, c), dtype, gen)
            tol = 1e-5 if dtype == torch.float32 else 1e-4
            errs = []
            for a, b in ((x, x), (g, x)):
                got = bn.pair_sums(a, b)
                ref = bn.pair_sums_plain(a, b)
                again = bn.pair_sums(a, b)
                torch.cuda.synchronize()
                require(all(torch.equal(u, v) for u, v in zip(got, again)),
                        f"pair_sums {(m, c)} {dtype}: a repeated call differs")
                for gt, rf in zip(got, ref):
                    errs.append(rel_err(gt, rf))
                    max_abs = max(max_abs, float((gt - rf).abs().max()))
            err_f, err_b = max(errs[:2]), max(errs[2:])
            require(max(errs) <= tol, f"pair_sums {(m, c)} {dtype}: rel errs "
                    f"{errs} > {tol}")
            worst[dtype] = max(worst[dtype], max(errs))
            x4 = x.view(BATCH, h, w, c).permute(0, 3, 1, 2)
            g4 = g.view(BATCH, h, w, c).permute(0, 3, 1, 2)
            mean = torch.zeros(c, device=DEV)
            invstd = torch.ones(c, device=DEV)
            weight = torch.ones(c, device=DEV)
            t = [cuda_ms(lambda: bn.pair_sums(x, x)),
                 cuda_ms(lambda: bn.pair_sums_plain(x, x)),
                 cuda_ms(lambda: torch.batch_norm_stats(x4, 1e-5)),
                 cuda_ms(lambda: bn.pair_sums(g, x)),
                 cuda_ms(lambda: bn.pair_sums_plain(g, x)),
                 cuda_ms(lambda: torch.batch_norm_backward_reduce(
                     g4, x4, mean, invstd, weight, True, False, False))]
            isz = x.element_size()
            bf, byf = bound_ms(m * c * isz + 8 * c, 3 * m * c, dtype)
            bb, byb = bound_ms(2 * m * c * isz + 8 * c, 3 * m * c, dtype)
            by_ops |= "operations" in (byf, byb)
            log(f"[pair_sums] {BATCH} {c} {h} {w} {str(dtype)[6:]} x{mult}: "
                f"{err_f:.3g}, {err_b:.3g} | {t[0]:.4f} {t[1]:.4f} "
                f"{t[2]:.4f} {bf:.4f} | {t[3]:.4f} {t[4]:.4f} {t[5]:.4f} "
                f"{bb:.4f}")
            if dtype == torch.bfloat16:
                k = 2 * mult  # src and tgt
                totals["ms"] += k * (t[0] + t[3])
                totals["plain_ms"] += k * (t[1] + t[4])
                totals["library_ms"] += k * (t[2] + t[5])
                totals["bound_ms"] += k * (bf + bb)
            del x, g, x4, g4
    entry = {"name": "pair_sums", "route": "cuda",
             "source": "s2r_tpu_torch/csrc/batchnorm.cu",
             "replaces": "s2r_tpu/ops/pallas/batchnorm.py:77",
             "launches": None, "max_abs_err": max_abs, **totals,
             "bound_by": "operations" if by_ops else "bytes",
             "ms_covers": "one 512x1024 batch-8 bf16 train step: 60 "
                          "BatchNorms x (src, tgt) x (stats, backward sums) "
                          "= 240 launches"}
    log(f"[pair_sums] all checks passed; worst rel err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; one "
        f"train step (240 launches): kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.3f}, batch_norm_stats/backward_reduce "
        f"{entry['library_ms']:.3f}, bound {entry['bound_ms']:.3f}")
    return entry


def check_disc_conv1(dc):
    """Phase 2e: disc_conv1 at the step's shape, 8x19x512x1024 (the NCHW
    softmax map seen as [N,H,C,W]) -> 8x256x512x64, bf16 and float32.
    Returns the entry for one train step (3 launches)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    n, c, (h, w), ndf = BATCH, 19, TRAIN_HW, 64
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.randn((n, c, h, w), device=DEV, generator=gen)
        x_nchw = torch.softmax(logits, dim=0).to(dtype)
        del logits
        x = x_nchw.permute(0, 2, 1, 3)
        k = (torch.rand((4, 4, c, ndf), device=DEV, generator=gen) * 2 - 1
             ).mul_(1 / (16 * c) ** 0.5).to(dtype)
        b = (torch.rand((ndf,), device=DEV, generator=gen) * 0.2 - 0.1
             ).to(dtype)
        got = dc.disc_conv1(x, k, b)
        ref = dc.disc_conv1_plain(x, k, b)
        torch.cuda.synchronize()
        require(got.shape == (n, h // 2, w // 2, ndf) and got.dtype == dtype,
                f"disc_conv1 output {tuple(got.shape)} {got.dtype}")
        diff = (got.float() - ref.float()).abs()
        scale = ref.float().abs().clamp(min=1.0)
        if dtype == torch.float32:
            ok = float(diff.max()) <= 1e-5 * float(scale.max())
        else:
            ok = bool((diff <= 1e-2 * scale).all())
        err = float(diff.max())
        require(ok, f"disc_conv1 {dtype}: max_abs_err {err}")
        w_oihw = k.permute(3, 2, 0, 1).contiguous()
        kern = cuda_ms(lambda: dc.disc_conv1(x, k, b))
        plain = cuda_ms(lambda: dc.disc_conv1_plain(x, k, b))
        lib = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, b, stride=2,
                                       padding=1))
        isz = x.element_size()
        nbytes = (x.numel() + got.numel() + k.numel() + ndf) * isz
        flops = 2 * got.numel() * 16 * c
        bnd, by = bound_ms(nbytes, flops, dtype)
        rows[dtype] = (kern, plain, lib, bnd, by, err)
        # The kernel multiplies on the CUDA cores in float32: its own floor
        # is the float32 peak, a design note beside the bound.
        f32_floor = 1e3 * flops / PEAK_FLOP_PER_S[torch.float32]
        log(f"[disc_conv1] {str(dtype)[6:]}: max_abs_err {err:.3g} | kernel "
            f"{kern:.4f} ms, plain {plain:.4f}, F.conv2d {lib:.4f}, bound "
            f"{bnd:.4f} ({by}; bytes {1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms "
            f"for {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP at the "
            f"{str(dtype)[6:]} peak {1e3 * flops / PEAK_FLOP_PER_S[dtype]:.4f}"
            f" ms; float32 CUDA-core floor of this design {f32_floor:.4f} ms)")
        del x_nchw, x, got, ref, diff, scale
    kern, plain, lib, bnd, by, err = rows[torch.bfloat16]
    return {"name": "disc_conv1", "route": "cuda",
            "source": "s2r_tpu_torch/csrc/disc_conv.cu",
            "replaces": "s2r_tpu/ops/pallas/disc_conv.py:174",
            "launches": None, "max_abs_err": err, "ms": 3 * kern,
            "plain_ms": 3 * plain, "bound_ms": 3 * bnd, "bound_by": by,
            "library_ms": 3 * lib,
            "ms_covers": "one 512x1024 batch-8 bf16 train step: D's three "
                         "forwards = 3 launches"}


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
    reset(counted)
    state, metrics = method.step_fn(state, batch)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"[train 512x1024] launches in one step: {launches}")
    require(launches == {"depthwise_conv3x3": 56, "requant_s32_to_s8": 0,
                         "depthwise_dk": 28, "pair_sums": 240,
                         "disc_conv1": 3},
            f"unexpected launch counts {launches}")
    return ms, launches


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
               bn.pair_sums, dc.disc_conv1)
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
        kernels += [dk_entry, check_pair_sums(bn), check_disc_conv1(dc)]
        torch.cuda.empty_cache()
        serve_check_513(dw, rq)
        torch.cuda.empty_cache()
        ms, serve_launches = serve_full(counted)
        torch.cuda.empty_cache()
        train_check_small(counted)
        torch.cuda.empty_cache()
        step_ms, train_launches = train_full(counted)
        for k in kernels:
            paths = {"serve": serve_launches[k["name"]],
                     "train_step": train_launches[k["name"]]}
            k["launches"] = paths["serve"] + paths["train_step"]
            k["launches_by_path"] = paths
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
