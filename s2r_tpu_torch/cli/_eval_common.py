"""Shared logic of the val and test drivers (s2r_tpu/cli/_eval_common.py,
reference val.py / val_adapt.py / test.py / test_adapt.py).

- ``build_eval``: the method, a checkpoint loaded into it (``--resume``),
  its eval step and the loaders;
- ``validation_sep``: a forward per batch, each image's mIoU printed, and
  its prediction saved as a grayscale labelId PNG and a color PNG, both
  resized to 1280x640 as PIL's NEAREST resizes (val_adapt.py:179-218,
  222-242);
- ``validation``: aggregate metrics and the per-class IoU report appended
  to val_info.txt (val.py:146-211), byte for byte the JAX package's text
  for the same confusion matrix;
- ``test_sweep``: the label-free sweep saving the same two PNGs an image
  (test_adapt.py:118-178).

The port never imports PIL: data/imaging.py ``resize_nearest`` gives PIL's
NEAREST resize, and utils/png.py encodes the PNGs.  The names come from the
datasets (ValSet: the ``*_leftImg8bit.png`` of each label; TestSet and GTA5:
the image's file name; synthetic: ``synthetic_<index>.png``).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.core.device import resolve_device
from s2r_tpu_torch.data.datasets import VALID_CLASSES
from s2r_tpu_torch.data.device_aug import normalize_u8_batch
from s2r_tpu_torch.data.imaging import resize_nearest
from s2r_tpu_torch.data.loader import make_data_loader
from s2r_tpu_torch.data.palette import decode_segmap_u8
from s2r_tpu_torch.eval.metrics import Evaluator, evaluate
from s2r_tpu_torch.io.saver import Saver
from s2r_tpu_torch.parallel.feed import prefetch_to_device
from s2r_tpu_torch.train.setup import build_method
from s2r_tpu_torch.train.trainer import latest_checkpoint, resume_into
from s2r_tpu_torch.utils.png import write_png

EXPORT_SIZE = (1280, 640)  # (w, h): val.py:214-254 / test_adapt.py:118-157

# trainId -> Cityscapes labelId for the grayscale export (val.py imgsaver
# :219-224 maps predictions back through valid_classes).
_TRAINID_TO_LABELID = np.zeros(256, np.uint8)
_TRAINID_TO_LABELID[:len(VALID_CLASSES)] = VALID_CLASSES

# Short class names of the val_info.txt report (val.py:177-195).
REPORT_CLASS_NAMES = ("road", "sidewalk", "building", "wall", "fence",
                      "pole", "light", "sign", "vegetation", "terrain",
                      "sky", "person", "rider", "car", "truck", "bus",
                      "train", "motocycle", "bicycle")


def build_eval(cfg: Config, method: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None):
    """(method, G, eval_step, val_loader, test_loader, nclass); `cfg.resume`
    (a checkpoint of any format train/trainer.py ``resume_into`` reads, or
    'auto') is loaded as Trainer._resume loads it.  `method` None infers it
    from ``cfg.dataset``."""
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


def _save_prediction(pred: np.ndarray, name: str, out_dir: str,
                     dataset: str, miou: Optional[float] = None):
    """Grayscale labelId PNG (trainIds mapped back to Cityscapes labelIds)
    and color PNG, both resized to 1280x640 NEAREST; the color filename
    carries the per-image mIoU when given (val.py imgsaver:246-247)."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(name))[0]
    # NEAREST picks pixels, so it commutes with the per-pixel maps: resize
    # the labels once, then map the 1280x640 of them
    small = resize_nearest(pred, EXPORT_SIZE)
    write_png(os.path.join(out_dir, f"{stem}_labelId.png"),
              _TRAINID_TO_LABELID[small.astype(np.uint8)])
    tag = f"_color_{miou:.4f}_" if miou is not None else "_color"
    write_png(os.path.join(out_dir, f"{stem}{tag}.png"),
              decode_segmap_u8(small, dataset))


def _predictions(eval_step, loader, device):
    """(host batch, [N, H, W] numpy predictions) of each batch."""
    for batch in prefetch_to_device(loader, device):
        arrays = normalize_u8_batch(batch)
        _, _, pred = eval_step(arrays["image"], arrays["label"])
        yield batch, pred.cpu().numpy()


def validation_sep(cfg: Config, model, eval_step, val_loader, nclass: int,
                   out_dir: str):
    """Per-image predictions and per-image mIoU (val*.py validationSep),
    saved under `out_dir`."""
    for batch, pred in _predictions(eval_step, val_loader, model.device):
        label = batch["label"].cpu().numpy()
        for j in range(pred.shape[0]):
            ev = Evaluator(nclass)
            ev.add_batch(label[j:j + 1], pred[j:j + 1])
            miou, _ = ev.Mean_Intersection_over_Union()
            name = batch["name"][j]
            _save_prediction(pred[j], name, out_dir, cfg.dataset, miou)
            print(f"{name}: mIoU {miou:.4f}")


def test_sweep(cfg: Config, model, eval_step, test_loader, out_dir: str):
    """The label-free inference sweep (test*.py:150-178): both PNGs of
    each image under `out_dir`."""
    for batch, pred in _predictions(eval_step, test_loader, model.device):
        for j in range(pred.shape[0]):
            _save_prediction(pred[j], batch["name"][j], out_dir, cfg.dataset)
    print(f"saved predictions to {out_dir}")


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
