"""GTA5 -> Cityscapes adaptation sets and the GTA5 source-only set
(s2r_tpu/data/datasets.py, reference gtav2cityscapes.py and gta5.py), read
from PNG files without PIL (data/imaging.py).

- The 34 -> 19 Cityscapes trainId remap, void classes -> 255
  (gtav2cityscapes.py:27-35), as a 256-entry LUT.
- TrainSet pairs each labeled source frame with a target frame drawn by
  ``rng.randint`` before the transforms draw (gtav2cityscapes.py:54).
- ValSet lists '*gtFine_labelIds.png' and swaps the suffix for the image
  (gtav2cityscapes.py:103,125-128); TestSet lists the images and makes a
  constant-255 label when no label root is given (:201-207).
- GTA5 splits its file list 70/20/10 after ``random.Random(720)``'s
  shuffle (gta5.py:24-30), FixScaleCrop for val.
- Samples carry a 'name' key (eval sets and GTA5).
- ``staged=True`` returns the raw uint8 frames for the device augmentation
  (data/device_aug.py); ``cache=True`` keeps decoded frames in memory up to
  a byte cap and, without staging, crops them at crop resolution
  (data/hostcrop.py).

Every sample is uint8: the device normalizes (device_aug.normalize_u8_batch).
"""

from __future__ import annotations

import os
import random
import threading
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from s2r_tpu_torch.data import hostcrop, imaging
from s2r_tpu_torch.data import transforms as T

NUM_CLASSES = 19
IGNORE_INDEX = 255
VALID_CLASSES = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                 28, 31, 32, 33)
CLASS_NAMES = ("unlabelled", "road", "sidewalk", "building", "wall", "fence",
               "pole", "traffic_light", "traffic_sign", "vegetation",
               "terrain", "sky", "person", "rider", "car", "truck", "bus",
               "train", "motorcycle", "bicycle")

_LUT = np.full(256, IGNORE_INDEX, dtype=np.uint8)
_LUT[list(VALID_CLASSES)] = np.arange(NUM_CLASSES, dtype=np.uint8)


def encode_segmap(mask: np.ndarray) -> np.ndarray:
    """Raw Cityscapes labelIds -> 19 trainIds (void -> 255)."""
    return _LUT[mask.astype(np.uint8)]


def recursive_glob(rootdir: str, suffix: str = "") -> List[str]:
    """The sorted files of rootdir ending with suffix (gtav2cityscapes.py:
    85-91: a flat, sorted listdir despite the name)."""
    return [os.path.join(rootdir, f)
            for f in sorted(os.listdir(rootdir)) if f.endswith(suffix)]


def _load_label(path: str) -> np.ndarray:
    return encode_segmap(imaging.load_raw(path))


class _FrameCache:
    """Decoded frames kept in memory for the train sets (the tf.data
    ``.cache()`` idea).  A frame that would pass the byte cap is not kept and
    decodes on every access: GTA5's 24966 frames (~145 GB) do not fit,
    Cityscapes' (~19 GB) may.  Thread-safe for the loader's pool: a frame
    that one thread is decoding is waited for, not decoded again, so
    `misses` counts the decodes and `hits` the lookups served from memory.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        self._d: Dict[str, np.ndarray] = {}
        self._loading: Set[str] = set()
        self._cond = threading.Condition()
        self._total = 0
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0

    def get(self, path: str, load: Callable[[str], np.ndarray]
            ) -> np.ndarray:
        with self._cond:
            while path in self._loading:
                self._cond.wait()
            hit = self._d.get(path)
            if hit is not None:
                self.hits += 1
                return hit
            self.misses += 1
            self._loading.add(path)
        arr = None
        try:
            arr = load(path)
        finally:
            with self._cond:
                self._loading.discard(path)
                if arr is not None and (
                        self.max_bytes is None
                        or self._total + arr.nbytes <= self.max_bytes):
                    self._d[path] = arr
                    self._total += arr.nbytes
                self._cond.notify_all()
        return arr

    def nbytes(self) -> int:
        with self._cond:
            return self._total


def _frames(cache: Optional[_FrameCache], paths: Dict[str, str]) -> Dict:
    """{key: decoded frame} of {key: path} (labels encoded), through the
    cache if there is one."""
    out = {}
    for k, p in paths.items():
        load = _load_label if "label" in k else imaging.load_rgb
        out[k] = load(p) if cache is None else cache.get(p, load)
    return out


class TrainSet:
    """Paired (source image + label, random target image) training set."""

    NUM_CLASSES = NUM_CLASSES

    def __init__(self, src_img_root: str, src_label_root: str,
                 tgt_img_root: str, base_size: int, crop_size: int,
                 staged: bool = False, cache: bool = False,
                 cache_bytes: Optional[int] = None):
        self.src_label_root = src_label_root
        self.sources = recursive_glob(src_img_root, ".png")
        self.targets = recursive_glob(tgt_img_root, ".png")
        if not self.sources:
            raise FileNotFoundError(f"no source images in {src_img_root}")
        if not self.targets:
            raise FileNotFoundError(f"no target images in {tgt_img_root}")
        self.staged = staged
        self.cache = _FrameCache(cache_bytes) if cache else None
        self.base_size = base_size
        self.crop_size = crop_size
        self.transform = T.train_transforms(base_size, crop_size)

    def __len__(self):
        return len(self.sources)

    def __getitem__(self, index: int, rng: Optional[random.Random] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or random
        src_path = self.sources[index]
        paths = {"src_image": src_path,
                 "tgt_image": self.targets[
                     rng.randint(0, len(self.targets) - 1)],
                 "src_label": os.path.join(self.src_label_root,
                                           os.path.basename(src_path))}
        sample = _frames(self.cache, paths)
        if self.staged:
            return sample
        if self.cache is not None:
            return hostcrop.augment_sample(sample, rng, self.base_size,
                                           self.crop_size)
        return self.transform(sample, rng)


class ValSet:
    """Cityscapes validation set keyed by its label files."""

    NUM_CLASSES = NUM_CLASSES

    def __init__(self, img_root: str, label_root: str, crop_size: int):
        self.img_root = img_root
        self.labels = recursive_glob(label_root, "gtFine_labelIds.png")
        if not self.labels:
            raise FileNotFoundError(f"no labels in {label_root}")
        self.transform = T.eval_transforms(crop_size)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        label_path = self.labels[index]
        name = os.path.basename(label_path)[:-len("gtFine_labelIds.png")] \
            + "leftImg8bit.png"
        sample = {"image": imaging.load_rgb(os.path.join(self.img_root,
                                                         name)),
                  "label": _load_label(label_path)}
        out = self.transform(sample, rng)
        out["name"] = name
        return out


class TestSet:
    """Test sweep set, unlabeled (or with color labels)."""

    NUM_CLASSES = NUM_CLASSES
    __test__ = False  # not a pytest class (the reference's name)

    def __init__(self, img_root: str, label_root: str, crop_size: int):
        self.label_root = label_root
        self.images = recursive_glob(img_root, ".png")
        if not self.images:
            raise FileNotFoundError(f"no images in {img_root}")
        self.transform = T.eval_transforms(crop_size)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        image_path = self.images[index]
        name = os.path.basename(image_path)
        img = imaging.load_rgb(image_path)
        if self.label_root:
            label = _load_label(os.path.join(
                self.label_root,
                name[:-len("leftImg8bit.png")] + "gtFine_color.png"))
        else:
            label = np.full(img.shape[:2], IGNORE_INDEX, np.uint8)
        out = self.transform({"image": img, "label": label}, rng)
        out["name"] = name
        return out


class GTA5:
    """Single-domain GTA5 set with an in-memory 70/20/10 split (gta5.py)."""

    NUM_CLASSES = NUM_CLASSES

    def __init__(self, src_img_root: str, src_label_root: str,
                 base_size: int, crop_size: int, split: str = "train",
                 shuffle_seed: int = 720, staged: bool = False,
                 cache: bool = False, cache_bytes: Optional[int] = None):
        self.src_label_root = src_label_root
        self.split = split
        self.staged = staged and split == "train"
        self.cache = _FrameCache(cache_bytes) \
            if (cache and split == "train") else None
        self.base_size = base_size
        self.crop_size = crop_size
        files = recursive_glob(src_img_root, ".png")
        if not files:
            raise FileNotFoundError(f"no source images in {src_img_root}")
        random.Random(shuffle_seed).shuffle(files)
        n = len(files)
        if split == "train":
            self.files = files[:int(n * 0.7)]
            self.transform = T.train_transforms(base_size, crop_size)
        elif split == "val":
            self.files = files[int(n * 0.7):int(n * 0.9)]
            self.transform = T.val_scalecrop_transforms(crop_size)
        else:
            self.files = files[int(n * 0.9):]
            self.transform = T.eval_transforms(crop_size)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int, rng: Optional[random.Random] = None
                    ) -> Dict[str, np.ndarray]:
        rng = rng or random
        src_path = self.files[index]
        paths = {"image": src_path,
                 "label": os.path.join(self.src_label_root,
                                       os.path.basename(src_path))}
        sample = _frames(self.cache, paths)
        if self.staged:
            out = sample
        elif self.cache is not None:
            out = hostcrop.augment_sample(sample, rng, self.base_size,
                                          self.crop_size)
        else:
            out = self.transform(sample, rng)
        out["name"] = os.path.basename(src_path)
        return out
