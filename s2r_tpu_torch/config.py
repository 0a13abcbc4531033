"""The configuration fields the port's training reads, copied from
s2r_tpu/config.py with the same names and defaults.

The JAX package's Config holds the whole CLI surface; the port copies only
what ``train.setup.build_method`` reads for the output-space adaptation
step.  The CLI that fills it is later work.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    # --- model ---
    out_stride: int = 16
    num_classes: int = 19
    freeze_bn: bool = False

    # --- loss ---
    loss_type: str = "ce"  # 'ce' | 'focal'

    # --- training hyper-parameters ---
    epochs: int = 200
    lr: float = 5e-4
    lr_scheduler: str = "poly"  # 'poly' | 'step' | 'cos'
    lr_step: int = 0
    warmup_epochs: int = 0
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False

    # --- precision and seed ---
    # 'bf16' compute / f32 params, or 'f32'; the port adds 'f64' for
    # reference runs on the CPU (core/device.py).
    precision: str = "bf16"
    seed: int = 1

    # F.softmax(output, dim=0) over the batch axis feeding the output-space
    # discriminator (reference train_adapt.py:151,166,174): 'batch' is the
    # faithful setting, 'class' the per-pixel class softmax.
    adv_softmax_axis: str = "batch"
