"""The eval-transform normalization (s2r_tpu/data/transforms.py Normalize).

IMAGENET_MEAN and IMAGENET_STD are copied from s2r_tpu/data/transforms.py,
which the port cannot import (it pulls in PIL).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_rgb8(image: torch.Tensor) -> torch.Tensor:
    """Raw RGB bytes [..., 3] -> (x - 255*mean) / (255*std) in float32, the
    same float32 arithmetic as s2r_tpu/io/serving.py's rgb8 ingest."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=image.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=image.device) * 255.0
    return (image.float() - mean) / std
