"""The host augmentation pipeline without PIL (s2r_tpu/data/transforms.py).

The JAX module's transforms and compositions, on uint8 numpy arrays ([H, W,
3] images, [H, W] labels) in place of PIL Images, through the PIL-exact
operations of data/imaging.py.  Keys containing 'label' are masks (NEAREST,
padded with the ignore fill), every other key an RGB image (BILINEAR,
padded with 0).

Train (gtav2cityscapes.py:66-74): RandomHorizontalFlip ->
RandomScaleCrop(base, crop, fill=255) -> RandomGaussianBlur.
Eval (gtav2cityscapes.py:139-145): FixedResize(crop).
GTA5 val (gta5.py:81-88): FixScaleCrop(crop).

The JAX compositions end in Normalize and ToArray; here the samples stay
uint8 and the device finishes them (data/device_aug.py
``normalize_u8_batch``, the same float32 arithmetic), so a quarter of the
bytes cross to the card.  The draws from the per-sample ``random.Random``
are the JAX module's, in its order: the flip gate, the short edge, the crop
corner, the blur gate, then one radius for each image key in the sample's
key order.  RandomRotate, which no composition uses, is not ported
(ROADMAP A.4).
"""

from __future__ import annotations

import random as _random
from typing import Dict, Optional, Sequence

import numpy as np

from s2r_tpu_torch.data import imaging


def _is_mask(key: str) -> bool:
    return "label" in key


def _resize(key: str, v: np.ndarray, size) -> np.ndarray:
    if _is_mask(key):
        return imaging.resize_nearest(v, size)
    return imaging.resize_bilinear(v, size)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict, rng: Optional[_random.Random] = None):
        rng = rng or _random
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class RandomHorizontalFlip:
    """Flip all entries together with p = 0.5 (custom_transforms.py:59-71)."""

    def __call__(self, sample, rng):
        if rng.random() < 0.5:
            sample = {k: imaging.flip_lr(v) for k, v in sample.items()}
        return sample


class RandomGaussianBlur:
    """Blur the images (not the masks) with p = 0.5, each with its own
    radius U(0, 1) (custom_transforms.py:92-105)."""

    def __call__(self, sample, rng):
        if rng.random() < 0.5:
            sample = {k: (v if _is_mask(k) else
                          imaging.gaussian_blur(v, rng.random()))
                      for k, v in sample.items()}
        return sample


class RandomScaleCrop:
    """Short edge scaled to U{0.5 .. 2} x base_size, right/bottom padding
    (images 0, masks `fill`) up to the crop, a joint random crop
    (custom_transforms.py:108-147).  The geometry follows the first entry:
    the others are resized to its scaled extent."""

    def __init__(self, base_size: int, crop_size: int, fill: int = 0):
        self.base_size = base_size
        self.crop_size = crop_size
        self.fill = fill

    def __call__(self, sample, rng):
        short_size = rng.randint(int(self.base_size * 0.5),
                                 int(self.base_size * 2.0))
        h, w = next(iter(sample.values())).shape[:2]
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        out = {k: _resize(k, v, (ow, oh)) for k, v in sample.items()}
        if short_size < self.crop_size:
            padh = max(self.crop_size - oh, 0)
            padw = max(self.crop_size - ow, 0)
            out = {k: imaging.expand(v, padw, padh,
                                     self.fill if _is_mask(k) else 0)
                   for k, v in out.items()}
        h, w = next(iter(out.values())).shape[:2]
        x1 = rng.randint(0, w - self.crop_size)
        y1 = rng.randint(0, h - self.crop_size)
        box = (x1, y1, x1 + self.crop_size, y1 + self.crop_size)
        return {k: imaging.crop(v, box) for k, v in out.items()}


class FixScaleCrop:
    """Short edge scaled to crop_size, then a center crop
    (custom_transforms.py:150-178)."""

    def __init__(self, crop_size: int):
        self.crop_size = crop_size

    def __call__(self, sample, rng=None):
        h, w = next(iter(sample.values())).shape[:2]
        if w > h:
            oh = self.crop_size
            ow = int(1.0 * w * oh / h)
        else:
            ow = self.crop_size
            oh = int(1.0 * h * ow / w)
        out = {k: _resize(k, v, (ow, oh)) for k, v in sample.items()}
        h, w = next(iter(out.values())).shape[:2]
        x1 = int(round((w - self.crop_size) / 2.0))
        y1 = int(round((h - self.crop_size) / 2.0))
        box = (x1, y1, x1 + self.crop_size, y1 + self.crop_size)
        return {k: imaging.crop(v, box) for k, v in out.items()}


class FixedResize:
    """Resize everything to (size, size) (custom_transforms.py:180-196)."""

    def __init__(self, size: int):
        self.size = (size, size)

    def __call__(self, sample, rng=None):
        return {k: _resize(k, v, self.size) for k, v in sample.items()}


def train_transforms(base_size: int, crop_size: int) -> Compose:
    return Compose([RandomHorizontalFlip(),
                    RandomScaleCrop(base_size, crop_size, fill=255),
                    RandomGaussianBlur()])


def eval_transforms(crop_size: int) -> Compose:
    return Compose([FixedResize(crop_size)])


def val_scalecrop_transforms(crop_size: int) -> Compose:
    return Compose([FixScaleCrop(crop_size)])
