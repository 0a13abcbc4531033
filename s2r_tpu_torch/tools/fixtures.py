"""Full-size PNG fixtures in the layout of the real datasets, for runs
without the datasets (chip_smoke.py phase 7, tools/profile_driver.py).

Frames are the synthetic scenes (data/synthetic.py ``_scene``) made at an
eighth of the size and scaled up (BILINEAR images, NEAREST labels), so they
compress like smooth street scenes rather than noise.  Labels hold raw
Cityscapes labelIds (trainIds through ``VALID_CLASSES``, ignore -> 0):
GTA5's as P-mode PNGs with the Cityscapes colors in their palette,
Cityscapes' val labels as L-mode ``*_gtFine_labelIds.png``.  Every file
cycles the five PNG filter types row by row, so a decode exercises each.

    root/gta5/{images,labels}/NNNNN.png                       1914x1052
    root/cityscapes/leftImg8bit/{train,val,test}/*_leftImg8bit.png  2048x1024
    root/cityscapes/gtFine/val/*_gtFine_labelIds.png
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from s2r_tpu_torch.data import imaging
from s2r_tpu_torch.data.datasets import VALID_CLASSES
from s2r_tpu_torch.data.palette import get_cityscapes_labels
from s2r_tpu_torch.data.synthetic import _scene
from s2r_tpu_torch.utils.png import write_png

GTA5_HW = (1052, 1914)
CITYSCAPES_HW = (1024, 2048)
FILTERS = (0, 1, 2, 3, 4)
_KINDS = ("gta", "train", "val", "test")

_TO_LABELID = np.zeros(256, np.uint8)  # trainId -> labelId, 255 -> 0
_TO_LABELID[:len(VALID_CLASSES)] = VALID_CLASSES
PALETTE = np.zeros((256, 3), np.uint8)  # labelId -> its class color
PALETTE[list(VALID_CLASSES)] = get_cityscapes_labels()


def frame(seed: int, hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 [H, W, 3] image, uint8 [H, W] labelIds) of one scene."""
    h, w = hw
    img, lbl = _scene(np.random.RandomState(seed), h // 8, w // 8)
    return (imaging.resize_bilinear(img, (w, h)),
            imaging.resize_nearest(_TO_LABELID[lbl.astype(np.uint8)], (w, h)))


def roots(root: str) -> Dict[str, str]:
    """The Config fields that point the loaders at a fixture tree."""
    city = os.path.join(root, "cityscapes")
    return {"src_img_root": os.path.join(root, "gta5", "images"),
            "src_label_root": os.path.join(root, "gta5", "labels"),
            "tgt_img_root": os.path.join(city, "leftImg8bit", "train"),
            "val_img_root": os.path.join(city, "leftImg8bit", "val"),
            "val_label_root": os.path.join(city, "gtFine", "val"),
            "test_img_root": os.path.join(city, "leftImg8bit", "test")}


def write_fixtures(root: str, n_gta: int = 16, n_city: int = 16,
                   n_val: int = 8, n_test: int = 8
                   ) -> List[Tuple[str, str, np.ndarray]]:
    """Write the tree under `root`; returns (path, 'rgb' or 'raw', array
    written) of every file."""
    r = roots(root)
    for d in r.values():
        os.makedirs(d, exist_ok=True)
    jobs = [("gta", i, GTA5_HW) for i in range(n_gta)]
    jobs += [(split, i, CITYSCAPES_HW) for split, n in
             (("train", n_city), ("val", n_val), ("test", n_test))
             for i in range(n)]

    def one(job):
        kind, i, hw = job
        img, lbl = frame(_KINDS.index(kind) * 1009 + i, hw)
        out = []
        if kind == "gta":
            name = f"{i:05d}.png"
            out.append((os.path.join(r["src_img_root"], name), "rgb", img))
            out.append((os.path.join(r["src_label_root"], name), "raw", lbl))
            write_png(out[1][0], lbl, palette=PALETTE, filters=FILTERS,
                      level=1)
        else:
            stem = f"{kind}city_{i:06d}_000019_"
            d = r["tgt_img_root" if kind == "train" else f"{kind}_img_root"]
            out.append((os.path.join(d, stem + "leftImg8bit.png"), "rgb",
                        img))
            if kind == "val":
                out.append((os.path.join(r["val_label_root"],
                                         stem + "gtFine_labelIds.png"),
                            "raw", lbl))
                write_png(out[1][0], lbl, filters=FILTERS, level=1)
        write_png(out[0][0], img, filters=FILTERS, level=1)
        return out

    with ThreadPoolExecutor(8) as pool:
        return [f for files in pool.map(one, jobs) for f in files]
