"""The split BatchNorm entries of synchronized BatchNorm on one GPU: where
each call's time goes, the card's or the host's, beside PyTorch's calls.

    PYTHONPATH=<checkout> python s2r_tpu_torch/tools/profile_bn_split.py
        [--batch 4] [--height 512] [--width 1024] [--calls 20]

At every train-mode BatchNorm input shape of one MobileNetV2 DeepLab-V3+
forward at --height x --width, --batch images a rank (bf16; a rank's
share of the output step's batch 8 at world 2, as chip_smoke.py phase 10a
takes it), it times the second launch of the forward as the package on the
import path has it (``batch_norm_finish_apply``; an older checkout's
``batch_norm_finish`` + ``batch_norm_apply``), PyTorch's pair for the same
work (``batch_norm_gather_stats_with_counts`` + ``batch_norm_elemt``,
SyncBatchNorm's), ``batch_norm_grad_sums_local`` beside the fused
``batch_norm_grad_sums`` on the same rows and PyTorch's
``batch_norm_backward_reduce``, and ``batch_norm_sums`` beside
``batch_norm_stats``.  Each three ways (``split_times``): ms a call by CUDA
events around calls made back to back (what a caller sees: the larger
of the two below, roughly), the card's ms a call (torch.profiler's kernel
time over a window of calls; where the profiler sees no device time,
events around calls queued behind a ``torch.cuda._sleep``), and the host's
us a call (wall time of calls made with no synchronize, the median of
five rounds).  It prints a row a shape and, summed over a rank's step
(each shape's count in a forward, times 2: the source and target
forwards), one JSON line.  The line also holds ``digest``, a SHA-256 of
every entry's outputs on the seeded inputs (the statistics, y, the
running statistics and the backward rows, through the package's own
split route), so two checkouts that print the same digest computed the
same bits; and ``host_pieces_us``, what a ``batch_norm_grad_sums_local``
call's host time is made of at the step's most frequent shape (the C
entry alone, ``torch.empty`` of its workspace, the view of its head, the
current device and stream; the rest is the wrapper's checks and
Python).  It reads only the package on the import path, so it times
another checkout of the port too (compare two in one call, in turns).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import time
from collections import Counter

import torch

SLEEP_CYCLES = 20_000_000   # ~10 ms of the card's clock: ahead of the host


def events_ms(fn, calls: int = 10, warmup: int = 2) -> float:
    """Milliseconds a call of fn() by CUDA events around `calls` calls
    made back to back."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls: int = 20):
    """(the card's milliseconds a call of fn(), how they were taken):
    torch.profiler's CUDA kernel time summed over `calls` calls
    ("profiler"), or, if the profiler saw no device time or lost events
    (a kernel the calls launch seen fewer than `calls` times: after
    phases 1-9 of chip_smoke.py in one process it kept ~1 in 5 of the
    ctypes-launched kernels), CUDA events around `calls` calls queued
    behind a torch.cuda._sleep long enough for the host to launch them
    all, so that the card runs them back to back ("sleep": the launch
    gaps between them included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    if total > 0 and min(e.count for e in kernels) >= calls:
        return total / 1e3 / calls, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, "sleep"


def host_us(fn, calls: int = 20, rounds: int = 5) -> float:
    """The host's microseconds a call of fn(): wall time of `calls` calls
    made with no synchronize, the card idle before (few enough that
    the launch queue never fills); the median of `rounds` rounds."""
    fn()
    walls = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(walls) / calls


def split_times(fn, calls: int = 20) -> dict:
    """{"ms", "device_ms", "device_by", "host_us"} of fn() (see above)."""
    dev, by = device_ms(fn, calls)
    return {"ms": events_ms(fn), "device_ms": dev, "device_by": by,
            "host_us": host_us(fn, calls)}


def host_pieces(bn, build, g, x, st, gshift) -> dict:
    """What a batch_norm_grad_sums_local(g, x, st, gshift) call's host time
    is made of, in microseconds a call."""
    lib = bn._lib()
    sfx = {torch.float32: "f32", torch.bfloat16: "bf16"}[x.dtype]
    entry = (lib["grad_sums_local", x.dtype] if isinstance(lib, dict)
             else getattr(lib, f"s2r_bn_grad_sums_local_{sfx}"))
    head = bn.batch_norm_grad_sums_local(g, x, st, gshift)
    ws = head._base
    args = (g.data_ptr(), x.data_ptr(), st.data_ptr(), gshift.data_ptr(),
            ws.data_ptr(), *x.shape, build.stream(x))
    pieces = {
        "call": lambda: bn.batch_norm_grad_sums_local(g, x, st, gshift),
        "c_entry": lambda: entry(*args),
        "torch_empty": lambda: torch.empty(ws.shape, dtype=torch.float32,
                                           device=x.device),
        "head_view": lambda: ws[:len(head)],
        "current_device": torch.cuda.current_device,
        "stream": lambda: build.stream(x)}
    out = {k: host_us(f, calls=200) for k, f in pieces.items()}
    out["checks_and_python"] = out["call"] - sum(
        v for k, v in out.items() if k != "call")
    return out


def bn_shapes(hw, dtype: str = "bf16"):
    """(C, H, W) of every train-mode BatchNorm input of one MobileNetV2
    forward at hw, in call order (hooks on a throwaway model)."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.models.layers import BatchNorm

    model = DeepLab(dtype=dtype, device="cuda",
                    generator=torch.Generator().manual_seed(0))
    model.train()
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape[1:])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(torch.zeros((1, 3) + tuple(hw), device="cuda"))
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return shapes


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_bn_split: no CUDA device")
    from s2r_tpu_torch.ops.kernels import batchnorm as bn
    from s2r_tpu_torch.ops.kernels import build

    build.build_all(["batchnorm"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    folded = hasattr(bn, "batch_norm_finish_apply")
    counts = Counter(bn_shapes((a.height, a.width)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, eps, mom = a.batch, 1e-5, 0.1
    keys = ("forward", "forward_library", "grad_sums_local", "grad_sums",
            "backward_reduce", "sums", "stats")
    totals = {k: {"ms": 0.0, "device_ms": 0.0, "host_ms": 0.0} for k in keys}
    by = set()
    digest = hashlib.sha256()
    pieces = None
    route = "finish_apply" if folded else "finish + apply"
    print(f"[bn-split] {bn.__file__} ({route}); {a.width}x{a.height}, "
          f"{n} a rank, bf16; ms / device ms / host us a call: "
          f"{', '.join(keys)}; {smi}", flush=True)
    for (c, h, w), mult in sorted(counts.items()):
        x4 = torch.randn((n, h, w, c), device="cuda", generator=gen).to(
            torch.bfloat16)
        g4 = torch.randn((n, h, w, c), device="cuda", generator=gen).to(
            torch.bfloat16)
        x, g = x4.view(-1, c), g4.view(-1, c)
        x4n, g4n = x4.permute(0, 3, 1, 2), g4.permute(0, 3, 1, 2)
        weight = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        gshift = torch.randn(c, device="cuda", generator=gen)
        rm = torch.zeros(c, device="cuda")
        rv = torch.ones(c, device="cuda")
        count = 2 * n * (h + 2) * (w + 2)  # world 2, a ring of 1
        st = bn.batch_norm_stats(x, weight, bias, count, eps)
        sums = bn.batch_norm_sums(x)
        mean, invstd = st[bn.MEAN], st[bn.RSTD]
        mean2, invstd2 = torch.stack([mean, mean]), torch.stack([invstd,
                                                                 invstd])
        cnt2 = torch.full((2,), count / 2, device="cuda")
        # the bits of every entry's outputs, on fresh running statistics
        f_sums, f_rm, f_rv = sums.clone(), rm.clone(), rv.clone()
        if folded:
            y = bn.batch_norm_finish_apply(x, f_sums, weight, bias, count,
                                           eps, f_rm, f_rv, mom)
        else:
            f_sums = bn.batch_norm_finish(f_sums, weight, bias, count, eps,
                                          f_rm, f_rv, mom)
            y = bn.batch_norm_apply(x, f_sums[bn.INV], f_sums[bn.SHIFT])
        local = bn.batch_norm_grad_sums_local(g, x, st, gshift)
        grads = bn.batch_norm_grad_finish(local.clone(), st, count)
        for t in (st, sums[:2], f_sums, y.float(), f_rm, f_rv, local[:4],
                  grads, bn.batch_norm_grad_sums(g, x, st, gshift, count)):
            digest.update(t.cpu().numpy().tobytes())
        if mult == max(counts.values()) and pieces is None:
            pieces = host_pieces(bn, build, g, x, st, gshift)

        if folded:
            def forward():
                bn.batch_norm_finish_apply(x, sums, weight, bias, count, eps,
                                           rm, rv, mom)
        else:
            def forward():
                s = bn.batch_norm_finish(sums, weight, bias, count, eps, rm,
                                         rv, mom)
                bn.batch_norm_apply(x, s[bn.INV], s[bn.SHIFT])

        def forward_library():
            m_, i_ = torch.batch_norm_gather_stats_with_counts(
                x4n, mean2, invstd2, rm, rv, mom, eps, cnt2)
            torch.batch_norm_elemt(x4n, weight, bias, m_, i_, eps)

        fns = {"forward": forward, "forward_library": forward_library,
               "grad_sums_local": lambda: bn.batch_norm_grad_sums_local(
                   g, x, st, gshift),
               "grad_sums": lambda: bn.batch_norm_grad_sums(
                   g, x, st, gshift, count),
               "backward_reduce": lambda: torch.batch_norm_backward_reduce(
                   g4n, x4n, mean, invstd, weight, True, True, True),
               "sums": lambda: bn.batch_norm_sums(x),
               "stats": lambda: torch.batch_norm_stats(x4n, eps)}
        row = []
        for k in keys:
            t = split_times(fns[k], a.calls)
            by.add(t["device_by"])
            for key, v in (("ms", t["ms"]), ("device_ms", t["device_ms"]),
                           ("host_ms", t["host_us"] / 1e3)):
                totals[k][key] += 2 * mult * v
            row.append(f"{t['ms']:.4f}/{t['device_ms']:.4f}/"
                       f"{t['host_us']:.1f}")
        print(f"[bn-split] {n} {c} {h} {w} x{mult}: " + " ".join(row),
              flush=True)
        del x4, g4, x, g, x4n, g4n, fns
    print(json.dumps({"bn_split": totals, "folded": folded,
                      "device_by": sorted(by), "card": smi,
                      "digest": digest.hexdigest(),
                      "host_pieces_us": pieces,
                      "covers": f"a rank's output step ({a.width}x{a.height}, "
                                f"{n} a rank, bf16): ms summed over its "
                                "calls (each shape's count x 2)"}))


if __name__ == "__main__":
    main()
