"""Batched data loading with background prefetch (s2r_tpu/data/loader.py).

- ``make_data_loader(cfg)`` -> (train, val, test, nclass) with the JAX
  package's split, shuffle and drop_last semantics: shuffle train only,
  drop_last on train, and on val/test behind ``cfg.val_drop_last``.
- Samples are made in a thread pool with a bounded prefetch queue and
  stacked into NHWC numpy batches; ``parallel/feed.py`` moves them to the
  device.
- The epoch's order is ``random.Random((seed, epoch).__hash__())``, as in
  the JAX package.  Under data-parallel training (``process_index``,
  ``process_count``, from core/distributed.py ``process_info``) the batch
  size is the global batch: every rank builds the same permutation and
  takes ``b[rank::world]`` of each global batch, and a batch whose length
  the world does not divide is dropped on every rank (s2r_tpu/data/
  loader.py:46-66,87-91).  A tuple of ints hashes the same in every process
  (PYTHONHASHSEED salts only str and bytes), so the batches are
  bit-identical to JAX's.  Where the step takes the first n ranks of the
  world (core/mesh.py ``pick_num_devices``), the shares are theirs: n
  ranks split every batch and the others load nothing.  Under
  ``--spatial-shard`` the share is the
  rank's data row's, and under ``--eval-spatial-shard`` the eval loaders
  load whole batches (core/distributed.py ``process_shares``); the
  Trainer keeps each rank's band of the rows.
- ``gtav2cityscapes`` and ``gtav`` read the PNG roots of the config
  (data/datasets.py), staged for ``--device-aug`` and cached with
  ``--data-cache`` (up to ``--data-cache-gb``); ``synthetic`` makes scenes.
  Decode, resampling and blur run in C++ that releases the GIL, so the
  threads work in parallel.
- ``--data-backend native`` with ``gtav2cityscapes`` takes the native
  pipeline's loaders (data/native_loader.py: one C call a batch on
  ``--workers`` threads), as s2r_tpu/data/loader.py:140-167 does: the val
  images named after their labels, the test sweep unlabeled, the process
  share from core/distributed.py.  ``gtav`` and ``synthetic`` ignore the
  flag, as they do in the JAX package.
"""

from __future__ import annotations

import os
import queue
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from s2r_tpu_torch.config import Config, check_ported
from s2r_tpu_torch.core.distributed import process_shares
from s2r_tpu_torch.data import datasets as D
from s2r_tpu_torch.data import synthetic as S
from s2r_tpu_torch.data.native_loader import NativeEvalLoader, \
    NativeTrainLoader


def _collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack(vals)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1):
        if process_count > 1 and batch_size % process_count:
            raise ValueError(
                f"global batch_size {batch_size} must be divisible by "
                f"process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self):
        """The batches an epoch gives.  A ragged tail that the world does
        not divide is dropped, and not counted (the JAX package counts it:
        ROADMAP C.11)."""
        n, b = len(self.dataset), self.batch_size
        if self.drop_last:
            return n // b
        tail = n % b
        return n // b + (tail > 0 and tail % self.process_count == 0)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random((self.seed, self.epoch).__hash__()).shuffle(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        else:
            batches = [b for b in batches if b]
        if self.process_count > 1:
            batches = [b[self.process_index::self.process_count]
                       for b in batches if len(b) % self.process_count == 0]
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        epoch = self.epoch

        def fetch(i: int) -> Dict:
            rng = random.Random((self.seed, epoch, i).__hash__())
            return self.dataset.__getitem__(i, rng=rng)

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = queue.Queue()
            depth = min(self.prefetch, len(batches))

            def submit(batch_idx: int):
                pending.put([pool.submit(fetch, i)
                             for i in batches[batch_idx]])

            for b in range(depth):
                submit(b)
            next_to_submit = depth
            for _ in range(len(batches)):
                futs = pending.get()
                if next_to_submit < len(batches):
                    submit(next_to_submit)
                    next_to_submit += 1
                yield _collate([f.result() for f in futs])


def _native_loaders(cfg: Config, seed: int, train_set, val_set, test_set,
                    train_share, eval_share):
    """The gtav2cityscapes loaders of --data-backend native
    (s2r_tpu/data/loader.py:140-167); each share (index, count)."""
    train = NativeTrainLoader(train_set.sources, cfg.src_label_root,
                              train_set.targets, cfg.base_size,
                              cfg.crop_size, cfg.batch_size, seed=seed,
                              threads=cfg.workers,
                              process_index=train_share[0],
                              process_count=train_share[1])
    share = dict(threads=cfg.workers, process_index=eval_share[0],
                 process_count=eval_share[1])
    val_imgs = [os.path.join(
        cfg.val_img_root,
        os.path.basename(p)[:-len("gtFine_labelIds.png")] + "leftImg8bit.png")
        for p in val_set.labels]
    val = NativeEvalLoader(val_imgs, val_set.labels, cfg.crop_size,
                           cfg.batch_size, drop_last=cfg.val_drop_last,
                           **share)
    test = NativeEvalLoader(test_set.images, None, cfg.crop_size,
                            cfg.batch_size, drop_last=cfg.val_drop_last,
                            **share)
    return train, val, test, train_set.NUM_CLASSES


def make_data_loader(cfg: Config, seed: Optional[int] = None,
                     n_devices: Optional[int] = None):
    """(train, val, test, nclass), as s2r_tpu/data/loader.py:121-176 makes
    them (dataloders/__init__.py:4-28, plus the synthetic dataset), each
    loading this rank's share over the step's ranks: the world, or the
    first `n_devices` (core/distributed.py ``process_shares``)."""
    seed = cfg.seed if seed is None else seed
    check_ported(cfg)
    train_share, eval_share = process_shares(cfg.spatial_shard,
                                             cfg.eval_spatial_shard,
                                             n_devices)
    kw = dict(num_workers=cfg.workers, seed=seed)
    cache = dict(staged=cfg.device_aug, cache=cfg.data_cache,
                 cache_bytes=int(cfg.data_cache_gb * 1e9))
    if cfg.dataset == "gtav2cityscapes":
        train_set = D.TrainSet(cfg.src_img_root, cfg.src_label_root,
                               cfg.tgt_img_root, cfg.base_size,
                               cfg.crop_size, **cache)
        val_set = D.ValSet(cfg.val_img_root, cfg.val_label_root,
                           cfg.crop_size)
        test_set = D.TestSet(cfg.test_img_root, cfg.test_label_root,
                             cfg.crop_size)
        if cfg.data_backend == "native":
            return _native_loaders(cfg, seed, train_set, val_set, test_set,
                                   train_share, eval_share)
    elif cfg.dataset == "gtav":
        roots = (cfg.src_img_root, cfg.src_label_root, cfg.base_size,
                 cfg.crop_size)
        train_set = D.GTA5(*roots, "train", **cache)
        val_set = D.GTA5(*roots, "val")
        test_set = D.GTA5(*roots, "test")
    elif cfg.dataset == "synthetic":
        train_set = S.SyntheticTrainSet(cfg.crop_size,
                                        length=8 * cfg.batch_size,
                                        staged=cfg.device_aug)
        eval_n = 4 * max(cfg.batch_size, cfg.test_batch_size, 1)
        val_set = S.SyntheticEvalSet(cfg.crop_size, length=eval_n)
        test_set = S.SyntheticEvalSet(cfg.crop_size, length=eval_n // 2,
                                      seed=2)
    else:
        raise NotImplementedError(cfg.dataset)
    # all three loaders use batch_size (the reference parses
    # --test-batch-size and leaves it unused: dataloders/__init__.py:11-13)
    shares = dict(zip(("process_index", "process_count"), eval_share))
    train = DataLoader(train_set, cfg.batch_size, shuffle=True,
                       drop_last=True, process_index=train_share[0],
                       process_count=train_share[1], **kw)
    val = DataLoader(val_set, cfg.batch_size, shuffle=False,
                     drop_last=cfg.val_drop_last, **shares, **kw)
    test = DataLoader(test_set, cfg.batch_size, shuffle=False,
                      drop_last=cfg.val_drop_last, **shares, **kw)
    return train, val, test, train_set.NUM_CLASSES
