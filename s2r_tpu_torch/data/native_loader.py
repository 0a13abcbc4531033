"""Batch loaders over the native pipeline (``--data-backend native``;
s2r_tpu/data/native_loader.py).

One C call a batch (data/native.py) decodes, resizes, remaps and
normalizes on a std::thread pool, with one batch of lookahead on a Python
thread:

- ``NativeTrainLoader``: the paired train path (flip, RandomScaleCrop,
  blur, normalize / remap; reference custom_transforms.py:7-147) with a
  seeded augmentation stream a sample and a random target a sample
  (gtav2cityscapes.py:54).  The epoch's order is
  ``random.Random((seed, epoch).__hash__())``, the sample's seed
  ``(seed, epoch, i).__hash__()`` and its target the first draw of
  ``random.Random((seed, epoch, i).__hash__())``, as in the JAX package,
  so the batches are JAX's and a resumed epoch sees the same ones.
- ``NativeEvalLoader``: FixedResize eval batches for val and test sweeps.

Under data-parallel training the batch size is the global batch: every
rank builds the same batches and takes ``b[rank::world]`` of each, and a
batch whose length the world does not divide is dropped on every rank.
``len()`` counts the batches an epoch gives; the JAX package's
NativeEvalLoader also counts a ragged tail that its ranks drop (ROADMAP
C.11).
"""

from __future__ import annotations

import os
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from s2r_tpu_torch.data import native
from s2r_tpu_torch.data.datasets import _LUT
from s2r_tpu_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD


def _shard_batches(batches: List[List[int]], process_index: int,
                   process_count: int) -> List[List[int]]:
    """This rank's strided share of each global index batch; a batch whose
    length the world does not divide is dropped on every rank."""
    if process_count <= 1:
        return batches
    return [b[process_index::process_count] for b in batches
            if len(b) % process_count == 0]


def _lookahead(ranges: List[List[int]], load: Callable[[List[int]], Dict]
               ) -> Iterator[Dict]:
    """load(r) of each range in turn, the next one loading on a worker
    thread while the caller holds this one; its exception re-raises on the
    caller's thread."""
    if not ranges:
        return
    result = {}

    def fill(i):
        try:
            result[i] = load(ranges[i])
        except Exception as e:  # noqa: BLE001 — re-raised on the consumer
            result[i] = e

    t = threading.Thread(target=fill, args=(0,))
    t.start()
    for i in range(len(ranges)):
        t.join()
        batch = result.pop(i)
        if i + 1 < len(ranges):
            t = threading.Thread(target=fill, args=(i + 1,))
            t.start()
        if isinstance(batch, Exception):
            t.join()
            raise batch
        yield batch


def _check_share(batch_size: int, process_count: int) -> None:
    if process_count > 1 and batch_size % process_count:
        raise ValueError(
            f"global batch_size {batch_size} must be divisible by "
            f"process_count {process_count}")


class NativeTrainLoader:
    """Paired train loader: shuffled source epochs, a random target a
    sample, drop_last.  crop_size: an int (square) or (h, w)."""

    def __init__(self, src_imgs: List[str], label_root: str,
                 tgt_imgs: Optional[List[str]], base_size: int, crop_size,
                 batch_size: int, seed: int = 0, threads: int = 8,
                 blur: bool = True, emit_u8: bool = False,
                 process_index: int = 0, process_count: int = 1):
        _check_share(batch_size, process_count)
        self.process_index = process_index
        self.process_count = process_count
        self.src_imgs = src_imgs
        self.label_root = label_root
        self.tgt_imgs = tgt_imgs
        self.base_size = base_size
        self.crop_size = crop_size
        self.batch_size = batch_size
        self.seed = seed
        self.threads = threads
        self.blur = blur
        self.emit_u8 = emit_u8
        self.epoch = 0

    def __len__(self):
        return len(self.src_imgs) // self.batch_size  # drop_last

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _load(self, idx: List[int]) -> Dict:
        srcs = [self.src_imgs[i] for i in idx]
        lbls = [os.path.join(self.label_root, os.path.basename(p))
                for p in srcs]
        tgts = None
        if self.tgt_imgs is not None:
            tgts = []
            for i in idx:
                r = random.Random((self.seed, self.epoch, i).__hash__())
                tgts.append(self.tgt_imgs[r.randint(0,
                                                    len(self.tgt_imgs) - 1)])
        seeds = np.asarray(
            [(self.seed, self.epoch, i).__hash__() & 0xFFFFFFFFFFFFFFFF
             for i in idx], np.uint64)
        src, lbl, tgt = native.train_batch(
            srcs, lbls, tgts, self.base_size, self.crop_size, _LUT,
            IMAGENET_MEAN, IMAGENET_STD, seeds=seeds, blur=self.blur,
            emit_u8=self.emit_u8, threads=self.threads)
        out = {"src_image": src, "src_label": lbl}
        if tgt is not None:
            out["tgt_image"] = tgt
        return out

    def _index_batches(self) -> List[List[int]]:
        order = list(range(len(self.src_imgs)))
        random.Random((self.seed, self.epoch).__hash__()).shuffle(order)
        ranges = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        ranges = [b for b in ranges if len(b) == self.batch_size]
        return _shard_batches(ranges, self.process_index,
                              self.process_count)

    def __iter__(self) -> Iterator[Dict]:
        yield from _lookahead(self._index_batches(), self._load)


class NativeEvalLoader:
    """FixedResize eval batches in order; `lbl_paths` None gives labels of
    255 (a test sweep).  Each batch carries its images' base names."""

    def __init__(self, img_paths: List[str], lbl_paths: Optional[List[str]],
                 crop_size: int, batch_size: int, drop_last: bool = True,
                 threads: int = 8, process_index: int = 0,
                 process_count: int = 1):
        _check_share(batch_size, process_count)
        self.process_index = process_index
        self.process_count = process_count
        self.img_paths = img_paths
        self.lbl_paths = lbl_paths
        self.crop = crop_size
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.threads = threads

    def __len__(self):
        """The batches an epoch gives (a ragged tail the world does not
        divide is dropped, and not counted)."""
        return len(self._index_batches())

    def set_epoch(self, epoch: int):
        pass

    def _load(self, idx: List[int]) -> Dict:
        imgs = [self.img_paths[i] for i in idx]
        lbls = (None if self.lbl_paths is None
                else [self.lbl_paths[i] for i in idx])
        images, labels = native.eval_batch(imgs, lbls, self.crop, _LUT,
                                           IMAGENET_MEAN, IMAGENET_STD,
                                           self.threads)
        return {"image": images, "label": labels,
                "name": [os.path.basename(p) for p in imgs]}

    def _index_batches(self) -> List[List[int]]:
        n = len(self.img_paths)
        ranges = [list(range(lo, min(lo + self.batch_size, n)))
                  for lo in range(0, n, self.batch_size)]
        if self.drop_last:
            ranges = [b for b in ranges if len(b) == self.batch_size]
        return _shard_batches(ranges, self.process_index,
                              self.process_count)

    def __iter__(self) -> Iterator[Dict]:
        yield from _lookahead(self._index_batches(), self._load)
