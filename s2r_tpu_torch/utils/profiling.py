"""Profiling hooks (s2r_tpu/utils/profiling.py).

- ``trace(logdir)``: a context manager over ``torch.profiler.profile`` with
  the CPU and, where torch has it, the CUDA activity.  When it ends it
  writes one Chrome/TensorBoard trace file under `logdir`
  (``<host>_<pid>.<ns>.pt.trace.json``, torch.profiler's
  ``tensorboard_trace_handler``) holding the host's operators and the
  card's kernels under their own names (``dw3x3_sweep``, the BatchNorm
  entries, ``disc_conv1_tc``).  A falsy `logdir` does nothing.
  ``Trainer.fit`` wraps its epochs in it (``--profile-dir``), as the JAX
  Trainer wraps them in ``jax.profiler.trace``.
  The profiler keeps every event in host memory until the end, so a
  traced run grows with its length.  On an NVIDIA H100 80GB HBM3 at
  700.00 W (chip_smoke.py phase 11e, train_adapt --data-backend native
  at 512x512 batch 8 on full-size fixtures, ~4300 kernels a step): one
  traced epoch of 2 steps and an image-logging forward held 26-41 MiB
  of host memory before its export and wrote 21.6-21.7 MiB; the epoch
  with its validation batch wrote 24.3-24.4 MiB (two runs).  That is
  ~10-20 MiB of host memory and ~10 MiB of file a step: trace a few
  epochs, not a whole run.
- ``StepTimer``: wall-clock step times with a percentile summary, no
  synchronization beyond what the caller does.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    def __init__(self):
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {"steps": len(arr),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3)}
