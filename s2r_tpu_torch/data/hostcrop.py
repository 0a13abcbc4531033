"""The scale-crop computed at crop resolution from cached decoded frames
(s2r_tpu/data/hostcrop.py: ``--data-cache`` without ``--device-aug``).

The train transforms resize a whole frame before cropping it.  Here PIL's
``box=`` resampling (data/imaging.py ``resize_bilinear``) reads only the
window that the crop maps to, so the work follows the crop, not the frame;
with the decoded-frame cache a steady epoch decodes no PNG and resizes no
full frame.  The crops stay uint8 and the device normalizes them
(device_aug.normalize_u8_batch).

The arithmetic is the JAX module's: the box of the unflipped frame, the
output mirrored after (flip commutes with the symmetric filter), labels
gathered by PIL's NEAREST picks, the pad on the output's right and bottom,
and the draws in the train transforms' order (flip gate, short edge, crop
corner, blur gate, one radius per image).
"""

from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np

from s2r_tpu_torch.data import imaging

IGNORE_INDEX = 255


def draw_params(rng: random.Random, base_size: int, ch: int, cw: int,
                w: int, h: int) -> Tuple[bool, int, int, int, int]:
    """(flip, ow, oh, x1, y1) with the train composition's draw order:
    RandomHorizontalFlip's gate, then RandomScaleCrop's short edge and crop
    corner over the padded extent (custom_transforms.py:59-71,114-143)."""
    flip = rng.random() < 0.5
    short = rng.randint(int(base_size * 0.5), int(base_size * 2.0))
    if h > w:
        ow = short
        oh = int(1.0 * h * ow / w)
    else:
        oh = short
        ow = int(1.0 * w * oh / h)
    # right/bottom padding up to the crop (the reference's `short < crop`
    # gate: when short >= crop both scaled sides are >= crop)
    pw = max(cw - ow, 0)
    ph = max(ch - oh, 0)
    x1 = rng.randint(0, ow + pw - cw)
    y1 = rng.randint(0, oh + ph - ch)
    return flip, ow, oh, x1, y1


def _nearest_picks(n: int, on: int, flipped: bool) -> np.ndarray:
    """PIL's NEAREST source indices for resizing extent n -> on, of the
    mirrored frame when `flipped`."""
    idx = imaging.nearest_index(n, on)
    return n - 1 - idx if flipped else idx


def scalecrop_from_frame(frame: np.ndarray, ow: int, oh: int, x1: int,
                         y1: int, ch: int, cw: int, flip: bool,
                         is_mask: bool) -> np.ndarray:
    """The (ch, cw) crop of pad(resize(flip(frame), (ow, oh))) from the
    unflipped uint8 frame: box resampling of the mirrored window, then a
    mirror of the output (images), or a gather of the NEAREST picks
    (masks).  The padding stays on the output's right and bottom."""
    h, w = frame.shape[0], frame.shape[1]
    iw = min(cw, ow - x1)  # the crop's extent that is not padding
    ih = min(ch, oh - y1)
    if is_mask:
        ys = _nearest_picks(h, oh, False)[y1:y1 + ih]
        xs = _nearest_picks(w, ow, flip)[x1:x1 + iw]
        part = frame[ys][:, xs]
    else:
        lo_x = (ow - x1 - iw) if flip else x1
        box = (lo_x * w / ow, y1 * h / oh,
               (lo_x + iw) * w / ow, (y1 + ih) * h / oh)
        part = imaging.resize_bilinear(frame, (iw, ih), box=box)
        if flip:
            part = part[:, ::-1]
    if iw == cw and ih == ch:
        return np.ascontiguousarray(part)
    canvas = np.full((ch, cw) + frame.shape[2:],
                     IGNORE_INDEX if is_mask else 0, np.uint8)
    canvas[:ih, :iw] = part
    return canvas


def augment_sample(sample: Dict[str, np.ndarray], rng: random.Random,
                   base_size: int, crop_size: int) -> Dict[str, np.ndarray]:
    """Flip + scale-crop + blur over a dict of uint8 frames, the geometry
    keyed to the first entry's size as the train transforms key it (every
    frame maps onto that scaled extent).  Returns uint8 crops."""
    ch = cw = int(crop_size)
    first = next(iter(sample.values()))
    flip, ow, oh, x1, y1 = draw_params(rng, base_size, ch, cw,
                                       first.shape[1], first.shape[0])
    out = {k: scalecrop_from_frame(v, ow, oh, x1, y1, ch, cw, flip,
                                   "label" in k)
           for k, v in sample.items()}
    if rng.random() < 0.5:
        out = {k: (v if "label" in k else
                   imaging.gaussian_blur(v, rng.random()))
               for k, v in out.items()}
    return out
