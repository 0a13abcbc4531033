"""Trainer: the host-side loop of the training drivers, shared by the
three methods (s2r_tpu/train/trainer.py:97-397, reference train.py and
train_adapt.py:29-255).  With no method given it is inferred from
``cfg.dataset`` (train/setup.py build_method).

Data loaders, the method (train/setup.py), class-balanced weights, the
experiment saver, summaries, resume, and the epoch loop with validation and
best-mIoU checkpointing, on one device (``cuda`` unless the caller passes
``device="cpu"``) or data parallel, one process per device.

- Batches are prefetched to the device (parallel/feed.py) and, with
  ``--device-aug``, augmented there (data/device_aug.py) from a sampler
  seeded by (seed, epoch) and the batch index.  A uint8 batch is
  normalized there; the native route's float32 batches (``--data-backend
  native``, already cropped and normalized on the host) pass through, and
  under ``--device-aug`` are warped once more, as the JAX Trainer does
  (s2r_tpu/train/trainer.py:265-275; ROADMAP C.13).
- ``--profile-dir`` traces the epochs (utils/profiling.py).
- The step's metrics stay on the device during the epoch and are read once
  after it, as the JAX package does.
- Validation accumulates the eval step's confusion matrices on the device
  in int64 (eval/metrics.py).

Data parallel (a process group of more than one, core/distributed.py;
s2r_tpu/train/trainer.py:97-133): each rank loads and augments its share
of every global batch, and the step keeps the ranks' states equal
(train/steps.py).  After init, ``--backbone-init`` and ``--resume``
(every rank reads the same file) rank 0's state is broadcast, and each
rank's dropout generator is seeded from (seed, rank, step).  Validation
splits the val set over the ranks and all-reduces the confusion matrix
and the loss, so best_pred is the same everywhere.  Rank 0 alone owns
the experiment directory, the summaries and the checkpoints; the others
write nothing, and train-image logging is skipped.  A barrier precedes
``--resume auto``'s search and ends ``fit``.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, Optional, Union

import torch

from s2r_tpu_torch.config import Config, check_ported
from s2r_tpu_torch.core.device import resolve_device
from s2r_tpu_torch.core.mesh import (pick_num_devices, rank_seed,
                                     state_tensors)
from s2r_tpu_torch.data import device_aug as DA
from s2r_tpu_torch.data.loader import make_data_loader
from s2r_tpu_torch.eval.metrics import evaluate
from s2r_tpu_torch.io.checkpoint import load_checkpoint, restore_state
from s2r_tpu_torch.io.torch_import import apply_reference, init_backbone
from s2r_tpu_torch.io.saver import CKPT_NAME, Saver
from s2r_tpu_torch.parallel.feed import prefetch_to_device
from s2r_tpu_torch.train.setup import Method, build_method
from s2r_tpu_torch.utils.calculate_weights import load_or_compute_weights
from s2r_tpu_torch.utils.profiling import trace
from s2r_tpu_torch.utils.summaries import TensorboardSummary


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest checkpoint across a run directory's experiments."""
    candidates = glob.glob(os.path.join(directory, "experiment_*", CKPT_NAME))
    return max(candidates, key=os.path.getmtime) if candidates else None


def resume_into(state, path: str, ft: bool):
    """Load checkpoint `path` into `state`: the port's own, the JAX
    package's msgpack ``.ckpt`` or a reference ``.pth``/``.pth.tar``
    (io/checkpoint.py tells them apart).  With `ft` (the reference's
    default) the weights and BatchNorm statistics only, a fresh optimizer,
    step and dropout generator; else everything the file holds (a
    reference file: the optimizer buffers, with the JAX Trainer's rules,
    io/torch_import.py ``apply_reference``).  Returns (epoch, best_pred) of
    the checkpoint."""
    if not os.path.isfile(path):
        raise RuntimeError(f"=> no checkpoint found at '{path}'")
    payload = load_checkpoint(path, state.G.backbone_name)
    if payload["format"] == "reference":
        ref = payload["reference"]
        apply_reference(state, ref, ft)
        print(f"=> imported reference checkpoint '{path}' (epoch "
              f"{ref['epoch']}, schema {ref['schema']})")
    else:
        restore_state(state, payload["state"], full=not ft)
        print(f"=> loaded {'JAX ' if payload['format'] == 'jax' else ''}"
              f"checkpoint '{path}' (epoch {payload['epoch']})")
    return payload["epoch"], payload["best_pred"]


class _NullWriter:
    """Summary-writer stand-in for the ranks other than 0."""

    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, cfg: Config, method: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        check_ported(cfg, method)
        self.cfg = cfg
        self.device = resolve_device(device)
        n_devices = pick_num_devices(cfg.batch_size, cfg.num_devices)
        self.train_loader, self.val_loader, self.test_loader, self.nclass = \
            make_data_loader(cfg)
        weights = None
        if cfg.use_balanced_weights:
            weights = torch.as_tensor(load_or_compute_weights(
                cfg, self.train_loader, self.nclass), device=self.device)
        self.method: Method = build_method(cfg, len(self.train_loader),
                                           weights, method,
                                           device=self.device,
                                           n_devices=n_devices)
        self.mesh = self.method.mesh
        # rank 0 alone owns the experiment directory, summaries and
        # checkpoints (s2r_tpu/train/trainer.py:101-113)
        self.is_main = self.mesh.rank == 0
        self.saver = Saver(cfg, create=self.is_main)
        if self.is_main:
            self.saver.save_experiment_config()
            self.summary = TensorboardSummary(self.saver.experiment_dir)
            self.writer = self.summary.create_summary()
        else:
            self.summary, self.writer = None, _NullWriter()
        self.state = self.method.init_state()
        self.train_step = self.method.step_fn
        self.eval_step = self.method.eval_step
        self.evaluator = None  # the last validation's (eval/metrics.py)
        self.best_pred = 0.0
        self.start_epoch = cfg.start_epoch
        if cfg.backbone_init:
            init_backbone(self.state.G, cfg.backbone_init)
            print(f"=> initialized backbone from '{cfg.backbone_init}'")
        if cfg.resume:
            self._resume(cfg.resume)
        if self.mesh.size > 1:
            self.mesh.broadcast_(state_tensors(self.state))
            self.state.generator.manual_seed(
                rank_seed(cfg.seed, self.mesh, self.state.step))

    # ------------------------------------------------------------------
    def _resume(self, path: str):
        """Resume from a checkpoint of any format resume_into reads
        (train.py:120-142, train_adapt.py:94-113): with --ft (the default)
        the optimizer state is not restored and start_epoch stays;
        ``auto`` takes the newest checkpoint.ckpt of this run directory."""
        if path == "auto":
            self.mesh.barrier()
            path = latest_checkpoint(self.saver.directory)
            if path is None:
                print("=> --resume auto: no prior checkpoint found, "
                      "starting fresh")
                return
        epoch, self.best_pred = resume_into(self.state, path, self.cfg.ft)
        if not self.cfg.ft:
            self.start_epoch = epoch

    # ------------------------------------------------------------------
    def _finish_batch(self, arrays: Dict, epoch: int, i: int) -> Dict:
        """A device batch of uint8 frames -> the step's inputs."""
        cfg = self.cfg
        if not cfg.device_aug:
            return DA.normalize_u8_batch(arrays)
        gen = DA.batch_generator(cfg.seed, epoch, i)
        shard = dict(process_index=self.mesh.rank,
                     process_count=self.mesh.size)
        if "src_image" in arrays:
            return DA.augment_paired_batch(arrays, gen, cfg.base_size,
                                           cfg.crop_size, **shard)
        return DA.augment_batch(arrays, gen, cfg.base_size, cfg.crop_size,
                                **shard)

    def training(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        num_img_tr = len(self.train_loader)
        # ~10 image summaries an epoch (train_adapt.py:189); short epochs
        # log once
        vis_every = max(num_img_tr // 10, 1) if num_img_tr >= 10 \
            else max(num_img_tr, 1)
        pending = []  # device scalars, read after the epoch
        t0 = time.time()
        images_seen = 0
        for i, batch in enumerate(prefetch_to_device(self.train_loader,
                                                     self.device)):
            arrays = self._finish_batch(
                {k: v for k, v in batch.items() if torch.is_tensor(v)},
                epoch, i)
            self.state, metrics = self.train_step(self.state, arrays)
            pending.append(metrics)
            images_seen += cfg.batch_size
            if i % vis_every == 0 and self.mesh.size == 1:
                self._log_train_images(arrays, epoch * num_img_tr + i)

        sums: Dict[str, float] = {}
        if pending:
            for k in pending[0]:
                for v in torch.stack([m[k].double() for m in pending]
                                     ).cpu().tolist():
                    sums[k] = sums.get(k, 0.0) + v
        dt = time.time() - t0
        means = {k: v / max(len(pending), 1) for k, v in sums.items()}
        means["images_per_sec"] = images_seen / max(dt, 1e-9)
        for k, v in means.items():
            self.writer.add_scalar(f"train/{k}", v, epoch)
        loss_keys = [k for k in ("seg_loss", "task_loss", "adv_loss",
                                 "d_loss", "d_inv_loss") if k in sums]
        print(f"[Epoch: {epoch}, numImages: {images_seen:5d}] "
              + " ".join(f"{k}: {means[k]:.3f}" for k in loss_keys)
              + f" ({means['images_per_sec']:.1f} img/s)")

        if cfg.no_val and self.is_main:
            self.saver.save_checkpoint(self.state, epoch + 1, self.best_pred,
                                       is_best=False)
        return means

    def _log_train_images(self, arrays: Dict, global_step: int):
        try:
            img_key = "image" if "image" in arrays else "src_image"
            lbl_key = "label" if "label" in arrays else "src_label"
            image, label = arrays[img_key][:3], arrays[lbl_key][:3]
            _, _, pred = self.eval_step(image, label)
            self.summary.visualize_image(
                self.writer, self.cfg.dataset, image.cpu().numpy(),
                label.cpu().numpy(), pred.cpu().numpy(), global_step)
        except Exception as e:  # noqa: BLE001 — never kills training
            print(f"[warn] train image logging failed: {e}")

    # ------------------------------------------------------------------
    def validation(self, epoch: int) -> float:
        ev, test_loss = evaluate(self.eval_step, self.val_loader,
                                 self.device, self.nclass, self.mesh)
        self.evaluator = ev
        acc = ev.Pixel_Accuracy()
        acc_class = ev.Pixel_Accuracy_Class()
        miou, _ = ev.Mean_Intersection_over_Union()
        fwiou = ev.Frequency_Weighted_Intersection_over_Union()
        self.writer.add_scalar("val/total_loss_epoch", test_loss, epoch)
        self.writer.add_scalar("val/mIoU", miou, epoch)
        self.writer.add_scalar("val/Acc", acc, epoch)
        self.writer.add_scalar("val/Acc_class", acc_class, epoch)
        self.writer.add_scalar("val/fwIoU", fwiou, epoch)
        print("Validation:")
        print(f"[Epoch: {epoch}] Acc:{acc:.4f}, Acc_class:{acc_class:.4f}, "
              f"mIoU:{miou:.4f}, fwIoU: {fwiou:.4f}, Loss: {test_loss:.3f}")

        if miou > self.best_pred:
            self.best_pred = miou
            if self.is_main:
                self.saver.save_checkpoint(self.state, epoch + 1,
                                           self.best_pred, is_best=True)
        return miou

    # ------------------------------------------------------------------
    def fit(self):
        cfg = self.cfg
        print(f"Starting Epoch: {self.start_epoch}")
        print(f"Total Epoches: {cfg.epochs}")
        epoch = self.start_epoch
        try:
            with trace(cfg.profile_dir):
                for epoch in range(self.start_epoch, cfg.epochs):
                    self.training(epoch)
                    if not cfg.no_val and epoch % cfg.eval_interval == \
                            (cfg.eval_interval - 1):
                        self.validation(epoch)
        except KeyboardInterrupt:
            # an interrupt should not cost the epoch
            print(f"\n=> interrupted at epoch {epoch}; saving checkpoint")
            if self.is_main:
                self.saver.save_checkpoint(self.state, epoch, self.best_pred,
                                           is_best=False)
            raise
        finally:
            # every submitted save is on disk (or its error raised) before
            # fit() returns
            self.saver.wait()
            self.writer.close()
        self.mesh.barrier()

