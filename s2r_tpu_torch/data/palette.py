"""Label colorization (a numpy copy of s2r_tpu/data/palette.py, reference
dataloders/utils.py:5-108): the Cityscapes palette and trainId maps to RGB."""

from __future__ import annotations

import numpy as np


def get_cityscapes_labels() -> np.ndarray:
    return np.array([
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [0, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32]])


def _palette_for(dataset: str):
    if dataset in ("gtav2cityscapes", "gtav", "cityscapes", "synthetic"):
        return get_cityscapes_labels(), 19
    raise NotImplementedError(dataset)


def decode_segmap(label_mask: np.ndarray, dataset: str = "gtav2cityscapes"
                  ) -> np.ndarray:
    """[H, W] trainIds -> [H, W, 3] float RGB in [0, 1]; ids >= n_classes
    (the ignore label 255 among them) map to black."""
    colors, n = _palette_for(dataset)
    lut = np.zeros((256, 3), np.float32)
    lut[:n] = colors.astype(np.float32) / 255.0
    idx = np.clip(label_mask.astype(np.int64), 0, 255)
    return lut[idx]


def decode_segmap_u8(label_mask: np.ndarray,
                     dataset: str = "gtav2cityscapes") -> np.ndarray:
    """The uint8 variant, for PNG export: (decode_segmap * 255) truncated
    to uint8, through a table of that arithmetic's 256 results."""
    lut = (decode_segmap(np.arange(256), dataset) * 255.0).astype(np.uint8)
    return lut[np.clip(label_mask.astype(np.int64), 0, 255)]


def decode_seg_map_sequence(label_masks: np.ndarray,
                            dataset: str = "gtav2cityscapes") -> np.ndarray:
    """[N, H, W] -> [N, H, W, 3] float RGB."""
    return np.stack([decode_segmap(m, dataset) for m in label_masks])
