"""Segmentation metrics via an accumulated confusion matrix
(s2r_tpu/eval/metrics.py).

The reference Evaluator's method names and formulas (utils/metrics.py:4-46):
Pixel_Accuracy, Pixel_Accuracy_Class (nanmean), Mean_Intersection_over_Union
(returns (mIoU, per-class IoU), nanmean over NaN classes),
Frequency_Weighted_Intersection_over_Union, add_batch, reset, and merge.

The matrix is one ``torch.bincount`` of ``gt * C + pred`` on the tensors'
device, and the Evaluator accumulates it there in int64.  The JAX package
accumulates in float32, where counts past 2^24 in a cell round away
(ROADMAP C.8); here every count is exact, and float64 appears only when a
metric is read.

``evaluate`` is the validation loop that the Trainer and the val drivers
share.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from s2r_tpu_torch.data.device_aug import normalize_u8_batch
from s2r_tpu_torch.parallel.feed import prefetch_to_device


def confusion_matrix(gt: torch.Tensor, pred: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[C, C] int64 counts: rows ground truth, columns prediction.  Pixels
    whose gt lies outside [0, C) (the ignore label 255 among them) are
    left out; predictions are clipped into [0, C) as the JAX package does."""
    c = num_classes
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long().clamp(0, c - 1)
    valid = (gt >= 0) & (gt < c)
    # invalid pixels go to one extra bin, dropped below: no boolean
    # indexing, whose length the host would have to read
    idx = torch.where(valid, gt * c + pred, torch.full_like(gt, c * c))
    return torch.bincount(idx, minlength=c * c + 1)[:c * c].view(c, c)


def confusion_from_logits(logits: torch.Tensor, gt: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """Argmax over the class axis of NCHW logits, then the matrix."""
    return confusion_matrix(gt, logits.argmax(1), num_classes)


class Evaluator:
    """The reference Evaluator, accumulating in int64 on the device of the
    first matrix it is given."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.reset()

    def reset(self):
        self._cm: Optional[torch.Tensor] = None

    @property
    def confusion_matrix(self) -> np.ndarray:
        if self._cm is None:
            return np.zeros((self.num_class, self.num_class), np.float64)
        return self._cm.cpu().numpy().astype(np.float64)

    def merge(self, cm: torch.Tensor):
        """Accumulate a [C, C] matrix (the one the eval step returns)
        without leaving its device."""
        cm = cm.to(torch.int64)
        self._cm = cm.clone() if self._cm is None else self._cm + cm

    def add_batch(self, gt_image, pre_image):
        """gt / pred [N, H, W] class ids (tensors or numpy arrays)."""
        assert tuple(gt_image.shape) == tuple(pre_image.shape), (
            gt_image.shape, pre_image.shape)
        self.merge(confusion_matrix(torch.as_tensor(gt_image),
                                    torch.as_tensor(pre_image),
                                    self.num_class))

    def add_batch_from_logits(self, logits, gt_image):
        self.merge(confusion_from_logits(torch.as_tensor(logits),
                                         torch.as_tensor(gt_image),
                                         self.num_class))

    # --- metric formulas (reference metrics.py:9-32) ---
    def Pixel_Accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.diag(cm).sum() / cm.sum())

    def Pixel_Accuracy_Class(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(cm) / cm.sum(axis=1)
        return float(np.nanmean(acc))

    def Mean_Intersection_over_Union(self):
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float(np.nanmean(iou)), iou

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            freq = cm.sum(axis=1) / cm.sum()
            iu = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float((freq[freq > 0] * iu[freq > 0]).sum())


def evaluate(eval_step: Callable, loader: Iterable,
             device: Union[str, torch.device], num_class: int,
             mesh=None, band: Optional[Callable] = None
             ) -> Tuple[Evaluator, float]:
    """`eval_step` over the uint8 batches of `loader`, prefetched to
    `device` and normalized there: (the Evaluator holding the summed
    confusion matrix, the summed loss).  The matrices and losses stay on
    the device during the loop; the losses are read once after it.  Under
    `mesh` (core/mesh.py; data parallel, each rank evaluating its share of
    every batch, its loss the share of the batch's) the matrix and the
    loss are summed over the ranks, so every rank gets the global ones.
    `band` maps each device batch to the part this rank evaluates (its
    band of the rows under spatial sharding); its matrix and loss are
    shares too."""
    ev = Evaluator(num_class)
    losses = []
    for batch in prefetch_to_device(loader, device):
        arrays = normalize_u8_batch(band(batch) if band else batch)
        # a band carries its image's global height (core/mesh.py Layout)
        rows = {"height": arrays["height"]} if "height" in arrays else {}
        loss, cm, _ = eval_step(arrays["image"], arrays["label"], **rows)
        ev.merge(cm)
        losses.append(loss)
    if mesh is not None and mesh.size > 1:
        cm = ev._cm if ev._cm is not None else torch.zeros(
            (num_class, num_class), dtype=torch.int64, device=device)
        ev._cm = mesh.all_reduce_(cm.contiguous())
        total = torch.stack(losses).double().sum() if losses else \
            torch.zeros((), dtype=torch.float64, device=device)
        return ev, float(mesh.all_reduce_(total.reshape(1))[0])
    test_loss = 0.0
    if losses:
        for v in torch.stack(losses).double().cpu().tolist():
            test_loss += v
    return ev, test_loss
