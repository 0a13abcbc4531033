"""Training summaries: scalars and image grids (s2r_tpu/utils/summaries.py,
reference utils/summaries.py:7-23).

``scalars.jsonl`` in the experiment directory always; TensorBoard scalars
as well when ``torch.utils.tensorboard`` imports, which is tried when a
writer is made (importing this module loads neither TensorBoard nor PIL).
Image grids (the first three samples' inputs, predictions and labels) go
to PNGs under ``images/``, written by ``utils/png.py``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from s2r_tpu_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD
from s2r_tpu_torch.data.palette import decode_seg_map_sequence
from s2r_tpu_torch.utils.png import write_png


def _tensorboard_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter as TBWriter
    except Exception:  # noqa: BLE001 — TensorBoard is optional
        return None
    return TBWriter(logdir)


class SummaryWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = _tensorboard_writer(logdir) if use_tensorboard else None

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)

    def add_image(self, tag: str, img_hwc: np.ndarray, step: int):
        """img_hwc: float [H, W, 3] in [0, 1] -> images/{tag}_{step}.png."""
        d = os.path.join(self.logdir, "images")
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{tag.replace('/', '_')}_{step:08d}.png"),
                  (np.clip(img_hwc, 0, 1) * 255).astype(np.uint8))

    def close(self):
        self._jsonl.close()
        if self._tb:
            self._tb.close()


def unnormalize(images: np.ndarray) -> np.ndarray:
    """NHWC normalized -> [0, 1] RGB (the inverse of the normalization)."""
    img = images * np.asarray(IMAGENET_STD, np.float32) \
        + np.asarray(IMAGENET_MEAN, np.float32)
    return np.clip(img, 0.0, 1.0)


def _grid(images: np.ndarray, max_n: int = 3) -> np.ndarray:
    """The first max_n [H, W, 3] frames side by side."""
    n = min(images.shape[0], max_n)
    return np.concatenate(list(images[:n]), axis=1)


class TensorboardSummary:
    """The reference's facade (utils/summaries.py)."""

    def __init__(self, directory: str):
        self.directory = directory

    def create_summary(self) -> SummaryWriter:
        return SummaryWriter(self.directory)

    def visualize_image(self, writer: SummaryWriter, dataset: str,
                        image: np.ndarray, target: np.ndarray,
                        pred: np.ndarray, global_step: int):
        """image [N,H,W,3] normalized; target and pred [N,H,W] class ids
        (the JAX package passes one-hot logits and takes their argmax)."""
        image, target, pred = (np.asarray(a) for a in (image, target, pred))
        writer.add_image("Image", _grid(unnormalize(image)), global_step)
        writer.add_image("Predicted label",
                         _grid(decode_seg_map_sequence(pred[:3], dataset)),
                         global_step)
        writer.add_image("Groundtruth label",
                         _grid(decode_seg_map_sequence(target[:3], dataset)),
                         global_step)
