"""Experiment directories and best-checkpoint promotion (s2r_tpu/io/saver.py,
reference utils/saver.py:7-60).

- run/{dataset}/{checkname}/experiment_{id}, the id one past the highest
  existing one;
- save_checkpoint writes ``checkpoint.ckpt``; when it is the best it writes
  ``best_pred.txt`` and copies the checkpoint to ``model_best.ckpt`` in the
  run directory only if it beats the best_pred of every earlier experiment
  there (saver.py:23-42);
- save_experiment_config writes ``parameters.txt`` (with the reference's
  ``datset`` key, saver.py:44-60) and ``config.json``.

Saves are asynchronous unless ``cfg.async_save`` is off: the state is
copied on the device (io/checkpoint.py ``Snapshot``) and one ordered
writer thread moves it to the host and writes it; ``wait()`` joins it and
re-raises the first error.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Any, Dict, Optional

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.io.checkpoint import (AsyncWriter, Snapshot, host_tree,
                                         write_checkpoint)

CKPT_NAME = "checkpoint.ckpt"
BEST_NAME = "model_best.ckpt"


class Saver:
    def __init__(self, cfg: Config, create: bool = True):
        """create=False: compute the paths (for ``--resume auto``) but claim
        no experiment directory."""
        self.cfg = cfg
        self._writer = AsyncWriter() if cfg.async_save else None
        self.directory = os.path.join(cfg.run_root, cfg.dataset,
                                      cfg.checkname or "experiment")
        runs = sorted(glob.glob(os.path.join(self.directory, "experiment_*")),
                      key=lambda p: int(p.split("_")[-1]))
        run_id = int(runs[-1].split("_")[-1]) + 1 if runs else 0
        self.runs = runs
        self.experiment_dir = os.path.join(self.directory,
                                           f"experiment_{run_id}")
        if create:
            os.makedirs(self.experiment_dir, exist_ok=True)

    def save_checkpoint(self, state, epoch: int, best_pred: float,
                        is_best: bool, filename: str = CKPT_NAME,
                        extra: Optional[Dict[str, Any]] = None) -> str:
        """Save `state`; asynchronously, this returns once the device copy
        is enqueued, and the next step may update the state at once."""
        path = os.path.join(self.experiment_dir, filename)
        if self._writer is not None:
            snap = Snapshot(state)
            self._writer.submit(lambda: self._write(
                path, snap.to_host(), epoch, best_pred, is_best, extra))
        else:
            self._write(path, host_tree(state), epoch, best_pred, is_best,
                        extra)
        return path

    def _write(self, path, tree, epoch, best_pred, is_best, extra) -> None:
        write_checkpoint(path, tree, epoch, best_pred, extra)
        if is_best:
            with open(os.path.join(self.experiment_dir, "best_pred.txt"),
                      "w") as f:
                f.write(str(best_pred))
            previous = [0.0]
            for run in self.runs:
                p = os.path.join(run, "best_pred.txt")
                if os.path.exists(p):
                    with open(p) as f:
                        previous.append(float(f.readline()))
            if not self.runs or best_pred > max(previous):
                shutil.copyfile(path, os.path.join(self.directory, BEST_NAME))

    def wait(self) -> None:
        """Block until every pending write is on disk (no-op when saves are
        synchronous); re-raises the first write error."""
        if self._writer is not None:
            self._writer.wait()

    def save_experiment_config(self) -> None:
        cfg = self.cfg
        keys = [("datset", cfg.dataset),  # the reference's key (saver.py:48)
                ("backbone", cfg.backbone), ("out_stride", cfg.out_stride),
                ("lr", cfg.lr), ("lr_scheduler", cfg.lr_scheduler),
                ("loss_type", cfg.loss_type), ("epoch", cfg.epochs),
                ("base_size", cfg.base_size), ("crop_size", cfg.crop_size)]
        with open(os.path.join(self.experiment_dir, "parameters.txt"),
                  "w") as f:
            for k, v in keys:
                f.write(f"{k}:{v}\n")
        with open(os.path.join(self.experiment_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
