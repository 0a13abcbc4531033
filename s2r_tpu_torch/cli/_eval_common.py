"""Shared validation logic of the val drivers (s2r_tpu/cli/_eval_common.py,
reference val.py / val_adapt.py).

- ``build_eval``: the method, a checkpoint loaded into it (``--resume``),
  its eval step and the loaders;
- ``validation``: aggregate metrics and the per-class IoU report appended
  to val_info.txt (val.py:146-211), byte for byte the JAX package's text
  for the same confusion matrix.

``validation_sep`` and ``test_sweep`` write prediction PNGs upscaled to
1280x640 with PIL's NEAREST (val_adapt.py:179-242, test_adapt.py:118-178);
they wait for the image slice (ROADMAP A.4/A.5) and raise.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.core.device import resolve_device
from s2r_tpu_torch.data.loader import make_data_loader
from s2r_tpu_torch.eval.metrics import Evaluator, evaluate
from s2r_tpu_torch.io.saver import Saver
from s2r_tpu_torch.train.setup import build_method
from s2r_tpu_torch.train.trainer import latest_checkpoint, resume_into

# Short class names of the val_info.txt report (val.py:177-195).
REPORT_CLASS_NAMES = ("road", "sidewalk", "building", "wall", "fence",
                      "pole", "light", "sign", "vegetation", "terrain",
                      "sky", "person", "rider", "car", "truck", "bus",
                      "train", "motocycle", "bicycle")


def build_eval(cfg: Config, method: str,
               device: Optional[Union[str, torch.device]] = None):
    """(method, G, eval_step, val_loader, test_loader, nclass); `cfg.resume` (a checkpoint of the port, or 'auto') is loaded
    as Trainer._resume loads it."""
    device = resolve_device(device)
    train_loader, val_loader, test_loader, nclass = make_data_loader(cfg)
    m = build_method(cfg, max(len(train_loader), 1), method=method,
                     device=device)
    state = m.init_state()
    path = cfg.resume
    if path == "auto":
        path = latest_checkpoint(Saver(cfg, create=False).directory)
    if path:
        resume_into(state, path, cfg.ft)
    return m, m.eval_variables(state), m.eval_step, val_loader, \
        test_loader, nclass


def validation_sep(*args, **kwargs):
    """Per-image predictions and mIoU, saved as PNGs resized with PIL's
    NEAREST (val*.py validationSep): not ported."""
    raise NotImplementedError(
        "s2r_tpu_torch: per-image prediction export is not ported (ROADMAP "
        "A.4/A.5); pass --skip-sep")


def test_sweep(*args, **kwargs):
    """The label-free test sweep that saves prediction PNGs: not ported."""
    raise NotImplementedError(
        "s2r_tpu_torch: the test sweep's PNG export is not ported (ROADMAP "
        "A.4/A.5)")


def report_text(ev: Evaluator, test_loss: float, nclass: int):
    """(the report's text, mIoU, per-class IoU); the format mirrors
    val.py:196-203."""
    acc = ev.Pixel_Accuracy()
    acc_class = ev.Pixel_Accuracy_Class()
    miou, iou = ev.Mean_Intersection_over_Union()
    fwiou = ev.Frequency_Weighted_Intersection_over_Union()
    lines = ["Validation:",
             f"Acc:{acc}, Acc_class:{acc_class}, mIoU:{miou}, fwIoU: {fwiou}",
             f"Loss: {test_loss:.3f}", "", "Class IOU: "]
    for c in range(nclass):
        name = REPORT_CLASS_NAMES[c]
        sep = ": \t" if len(name) > 5 else ": \t\t"
        lines.append(f"\t{name}{sep}{iou[c]}")
    return "\n".join(lines), miou, iou


def validation(cfg: Config, model, eval_step, val_loader, nclass: int,
               report_path: Optional[str] = None):
    """Aggregate metrics and the per-class IoU report (val.py:146-211) of
    `eval_step` over `val_loader`, on `model`'s device.  Returns (mIoU,
    per-class IoU)."""
    ev, test_loss = evaluate(eval_step, val_loader, model.device, nclass)
    report, miou, iou = report_text(ev, test_loss, nclass)
    print(report)
    if report_path:
        os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
        with open(report_path, "a") as f:
            f.write(report + "\n\n")
    return miou, iou
