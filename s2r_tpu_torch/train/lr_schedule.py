"""Per-iteration learning-rate schedules (s2r_tpu/train/lr_schedule.py).

- poly: lr * (1 - T/N)^0.9
- cos:  0.5 * lr * (1 + cos(T/N * pi))
- step: lr * 0.1^(epoch // lr_step)
- optional linear warmup over warmup_epochs
with T = epoch * iters_per_epoch + i the global step and N = epochs *
iters_per_epoch.  The schedule is a plain function of the step, computed in
float32 as the JAX package computes it; the port's step counter lives on
the host, so reading the rate costs the device nothing.
"""

from __future__ import annotations

import numpy as np


def make_lr_schedule(mode: str, base_lr: float, num_epochs: int,
                     iters_per_epoch: int, lr_step: int = 0,
                     warmup_epochs: int = 0):
    """step (int) -> learning rate (np.float32)."""
    if mode not in ("poly", "cos", "step"):
        raise NotImplementedError(mode)
    if mode == "step" and not lr_step:
        raise ValueError("step schedule requires lr_step")
    f = np.float32
    total = f(max(num_epochs * iters_per_epoch, 1))
    warmup_iters = f(warmup_epochs * iters_per_epoch)
    base = f(base_lr)

    def schedule(step) -> np.float32:
        t = f(step)
        if mode == "poly":
            lr = base * np.maximum(f(1.0) - t / total, f(0.0)) ** f(0.9)
        elif mode == "cos":
            lr = f(0.5) * base * (f(1.0) + np.cos(t / total * f(np.pi)))
        else:
            epoch = np.floor(t / f(iters_per_epoch))
            lr = base * f(0.1) ** np.floor(epoch / f(lr_step))
        if warmup_iters > 0 and t < warmup_iters:
            lr = lr * t / warmup_iters
        return f(lr)

    return schedule
