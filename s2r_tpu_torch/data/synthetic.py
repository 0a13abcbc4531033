"""Synthetic datasets for data-free runs and tests (s2r_tpu/data/synthetic.py).

Structured random scenes with a fixed class -> color map (the Cityscapes
palette), so the task is learnable.  ``_scene`` draws the same numpy
RandomState stream as the JAX package, so the scenes are bit-identical.

Scenes flow through the same transforms as real data (data/transforms.py):
the train set emits the staged triple (``src_image``, ``tgt_image``,
``src_label``) for ``data/device_aug.py`` with ``staged``, else its
train-transformed crops; the eval set emits ``image`` and ``label`` through
the eval transforms.  Samples stay uint8 and the device normalizes them
(``device_aug.normalize_u8_batch``).
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np

from s2r_tpu_torch.data import transforms as T
from s2r_tpu_torch.data.palette import get_cityscapes_labels

NUM_CLASSES = 19

_COLORS = get_cityscapes_labels().astype(np.uint8)


def _scene(rng: np.random.RandomState, h: int, w: int):
    """A blocky scene: piecewise-constant label regions whose colors are a
    fixed function of the class, plus noise.  Returns (u8 image, i32 label).
    """
    label = np.zeros((h, w), np.int32)
    image = np.empty((h, w, 3), np.float32)
    image[:] = _COLORS[0]
    n_regions = rng.randint(4, 9)
    for _ in range(n_regions):
        cls = rng.randint(0, NUM_CLASSES)
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        hh, ww = rng.randint(h // 4, h), rng.randint(w // 4, w)
        label[y0:y0 + hh, x0:x0 + ww] = cls
        image[y0:y0 + hh, x0:x0 + ww] = _COLORS[cls]
    image += rng.randn(h, w, 3).astype(np.float32) * 12.0
    image = np.clip(image, 0, 255).astype(np.uint8)
    # sprinkle ignore pixels like real boundaries
    ignore = rng.rand(h, w) < 0.02
    label[ignore] = 255
    return image, label


class SyntheticTrainSet:
    NUM_CLASSES = NUM_CLASSES

    def __init__(self, crop_size: int, length: int = 64, paired: bool = True,
                 seed: int = 0, staged: bool = False):
        self.crop = crop_size
        self.length = length
        self.paired = paired
        self.seed = seed
        self.staged = staged
        self.transform = T.train_transforms(crop_size, crop_size)
        self.eval_transform = T.eval_transforms(crop_size)

    def __len__(self):
        return self.length

    def __getitem__(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        r = np.random.RandomState(self.seed * 100003 + index)
        img, lbl = _scene(r, self.crop, self.crop)
        if not self.paired:
            out = self.eval_transform({"image": img,
                                       "label": lbl.astype(np.uint8)})
            out["name"] = f"synthetic_{index:05d}.png"
            return out
        tgt, _ = _scene(r, self.crop, self.crop)
        sample = {"src_image": img, "tgt_image": tgt,
                  "src_label": lbl.astype(np.uint8)}
        if self.staged:
            return sample
        return self.transform(sample, rng or random)


class SyntheticEvalSet:
    NUM_CLASSES = NUM_CLASSES

    def __init__(self, crop_size: int, length: int = 16, seed: int = 1):
        self.inner = SyntheticTrainSet(crop_size, length, paired=False,
                                       seed=seed)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, index: int, rng=None):
        return self.inner.__getitem__(index)
