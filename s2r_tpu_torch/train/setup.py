"""Method assembly (s2r_tpu/train/setup.py:66-148): models, optimizers, the
initial TrainState, the step function and the eval step of a training
method, on any backbone of ``cfg.backbone`` (models/deeplab.py):

- 'output_adapt' (train_adapt.py): G and the FCDiscriminator, SGD with
  1x/10x groups for G and Adam (0.9, 0.99) for D;
- 'feature_adapt' (train.py): G and the DomainClassifier, with one
  ``--optimizer`` (``make_optimizer``) behind four states: 'task' over G,
  'd' over D, 'd_inv' over f = backbone + ASPP, and 'c' over G, which is
  allocated and never stepped;
- 'source_only' (train.py --dataset gtav): the same layout, task only.

With no method given it is inferred from ``cfg.dataset`` as the JAX
package does: 'gtav' is source-only, any other dataset feature_adapt.  A
Config setting the port lacks raises (config.check_ported).  One device:
`n_devices` must be 1, and batch padding (``--batch-pad``), which pays only
on a TPU, is off for either value.  Weights are drawn at build time
from `generator` (seeded with ``cfg.seed`` when None) on the CPU, and the
models then move to `device` (``cuda`` when None).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from s2r_tpu_torch.config import Config, check_ported
from s2r_tpu_torch.core.device import resolve_device
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.models.discriminator import FCDiscriminator
from s2r_tpu_torch.models.domain import DomainClassifier
from s2r_tpu_torch.train.losses import build_seg_loss
from s2r_tpu_torch.train.lr_schedule import make_lr_schedule
from s2r_tpu_torch.train.optim import (SGD, Adam, FusedOptimizer,
                                       make_optimizer)
from s2r_tpu_torch.train.state import TrainState
from s2r_tpu_torch.train.steps import (discriminator_params, domain_params,
                                       feature_params, make_eval_step,
                                       make_feature_adapt_step,
                                       make_output_adapt_step,
                                       segmenter_params)


@dataclasses.dataclass
class Method:
    """A wired training method."""
    name: str
    deeplab: DeepLab
    step_fn: Callable          # (TrainState, batch) -> (TrainState, metrics)
    eval_step: Callable        # (image, label) -> (loss, cm, pred)
    init_state: Callable       # () -> TrainState
    aux_model: Optional[torch.nn.Module] = None  # D: discriminator or
    # domain classifier

    def eval_variables(self, state: TrainState) -> torch.nn.Module:
        """The segmenter for eval and inference: the module `state` holds
        (it carries its own weights and statistics).  Its mode is left as
        it is: eval_step runs it in eval mode and restores the mode."""
        return state.G


def build_method(cfg: Config, iters_per_epoch: int,
                 class_weights: Optional[torch.Tensor] = None,
                 method: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 n_devices: int = 1) -> Method:
    if method is None:
        method = "source_only" if cfg.dataset == "gtav" else "feature_adapt"
    check_ported(cfg, method)
    if n_devices != 1:
        raise NotImplementedError(f"n_devices={n_devices}: the port runs on "
                                  "one device (ROADMAP A.8)")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    deeplab = DeepLab(num_classes=cfg.num_classes,
                      output_stride=cfg.out_stride, dtype=cfg.precision,
                      device=device, generator=generator,
                      freeze_bn=cfg.freeze_bn, backbone=cfg.backbone)
    seg_loss_fn = build_seg_loss(cfg.loss_type, class_weights)
    lr_fn = make_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.epochs,
                             iters_per_epoch, cfg.lr_step, cfg.warmup_epochs)
    eval_step = make_eval_step(deeplab, seg_loss_fn, cfg.num_classes)

    def new_generator() -> torch.Generator:
        return torch.Generator(device=device).manual_seed(cfg.seed)

    if method == "output_adapt":
        discr = FCDiscriminator(num_classes=cfg.num_classes,
                                dtype=cfg.precision, device=device,
                                generator=generator)
        # train_adapt.py:58-60: G = SGD(momentum, wd, nesterov), D = Adam
        # with betas (0.9, 0.99); the shared scheduler sets both rates.
        g_opt = SGD(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                    nesterov=cfg.nesterov)
        d_opt = Adam(b1=0.9, b2=0.99)
        step_fn = make_output_adapt_step(deeplab, discr, g_opt, d_opt, lr_fn,
                                         seg_loss_fn, cfg.adv_softmax_axis)

        def init_state() -> TrainState:
            """Step 0, zero optimizer state over the models' current
            weights, and a dropout generator on their device seeded with
            cfg.seed."""
            g_params, _ = segmenter_params(deeplab)
            d_params = discriminator_params(discr)
            g_state = FusedOptimizer(g_opt, g_params).init(g_params)
            d_state = FusedOptimizer(d_opt, d_params).init(d_params)
            return TrainState(step=0, G=deeplab, D=discr,
                              opt_state={"G": g_state, "D": d_state},
                              generator=new_generator())

        return Method(method, deeplab, step_fn, eval_step, init_state,
                      aux_model=discr)

    # feature_adapt / source_only (train.py:47-82)
    domain = DomainClassifier(backbone=cfg.backbone, dtype=cfg.precision,
                              device=device, generator=generator)
    opt = make_optimizer(cfg.optimizer, cfg.momentum, cfg.weight_decay,
                         cfg.nesterov)
    step_fn = make_feature_adapt_step(deeplab, domain, opt, opt, opt, lr_fn,
                                      seg_loss_fn,
                                      source_only=(method == "source_only"))

    def init_state() -> TrainState:
        """Step 0, the four zero optimizer states (train.py:63-82) over the
        models' current weights, and a dropout generator seeded with
        cfg.seed."""
        g_params, _ = segmenter_params(deeplab)
        d_params, f_params = domain_params(domain), feature_params(deeplab)

        def zero(params):
            return FusedOptimizer(opt, params).init(params)

        return TrainState(
            step=0, G=deeplab, D=domain,
            opt_state={"task": zero(g_params), "d": zero(d_params),
                       "d_inv": zero(f_params), "c": zero(g_params)},
            generator=new_generator())

    return Method(method, deeplab, step_fn, eval_step, init_state,
                  aux_model=domain)
