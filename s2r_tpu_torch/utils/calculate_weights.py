"""Class-balancing weights from a pass over the training labels (a numpy
copy of s2r_tpu/utils/calculate_weights.py, reference
utils/calculate_weights.py:5-30): weight_c = 1 / ln(1.02 + freq_c), cached
to .npy.  The label key follows the dataset ('label' for gtav, 'src_label'
otherwise)."""

from __future__ import annotations

import os

import numpy as np


def calculate_weights_labels(dataloader, num_classes: int, save_path: str,
                             dataset: str) -> np.ndarray:
    key = "label" if dataset == "gtav" else "src_label"
    z = np.zeros((num_classes,), np.float64)
    for batch in dataloader:
        y = np.asarray(batch[key])
        mask = (y >= 0) & (y < num_classes)
        z += np.bincount(y[mask].reshape(-1), minlength=num_classes)
    total = z.sum()
    weights = 1.0 / np.log(1.02 + z / max(total, 1.0))
    ret = weights.astype(np.float32)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        np.save(save_path, ret)
    return ret


def load_or_compute_weights(cfg, train_loader, num_classes: int) -> np.ndarray:
    """Cached at 'dataloders_cache/{dataset}_classes_weights.npy' (the
    reference's train.py:87, without its Windows separator)."""
    cache = os.path.join("dataloders_cache",
                         f"{cfg.dataset}_classes_weights.npy")
    if os.path.isfile(cache):
        return np.load(cache)
    return calculate_weights_labels(train_loader, num_classes, cache,
                                    cfg.dataset)
