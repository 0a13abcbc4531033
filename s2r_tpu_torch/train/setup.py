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
Config setting the port lacks raises (config.check_ported).  `n_devices`
is the step's ranks (core/mesh.py ``pick_num_devices``): the process
group, or its first n ranks, whose sub-world then carries every
collective, the layout and the dropout seeds (a rank past it raises
here: it builds nothing); ``--spatial-shard S`` lays them out as data
rows x S columns (core/mesh.py ``make_layout``) and
``--eval-spatial-shard`` splits the eval step's rows over all of them
(train/steps.py, spatial sharding).  Batch padding
(``--batch-pad``) keeps the JAX package's rule (``_step_pad_to``): it
pays only on a TPU, so both values give None here and the steps get no
``pad_to``; the steps pad when a caller gives them one.  ``--remat`` and
``--fast-pad-stats`` reach DeepLab (models/deeplab.py).  Weights are
drawn at build time from `generator` (seeded with ``cfg.seed`` when
None) on the CPU, and the models then move to `device` (``cuda`` when
None).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from s2r_tpu_torch.config import Config, check_ported
from s2r_tpu_torch.core.device import resolve_device
from s2r_tpu_torch.core.mesh import (IdleRank, Layout, Mesh, make_layout,
                                     make_mesh, rank_seed)
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.models.discriminator import FCDiscriminator
from s2r_tpu_torch.models.domain import DomainClassifier
from s2r_tpu_torch.models.layers import set_batchnorm_sync
from s2r_tpu_torch.train.losses import build_seg_loss
from s2r_tpu_torch.train.lr_schedule import make_lr_schedule
from s2r_tpu_torch.train.optim import (SGD, Adam, FusedOptimizer,
                                       make_optimizer)
from s2r_tpu_torch.train.state import TrainState
from s2r_tpu_torch.train.steps import (discriminator_params, domain_params,
                                       feature_params, make_eval_step,
                                       make_feature_adapt_step,
                                       make_output_adapt_step, path_stride,
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
    mesh: Mesh = dataclasses.field(default_factory=Mesh)  # data parallel
    layout: Optional[Layout] = None  # the mesh's (data x space) layout

    def eval_variables(self, state: TrainState) -> torch.nn.Module:
        """The segmenter for eval and inference: the module `state` holds
        (it carries its own weights and statistics).  Its mode is left as
        it is: eval_step runs it in eval mode and restores the mode."""
        return state.G


def _step_pad_to(cfg: Config, n_devices: int) -> Optional[int]:
    """The padded global batch of the train step, or None: the JAX
    package's rule (s2r_tpu/train/setup.py:51-62) off a TPU, where
    'auto' and 'off' both mean no padding."""
    return None


def build_method(cfg: Config, iters_per_epoch: int,
                 class_weights: Optional[torch.Tensor] = None,
                 method: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 n_devices: int = 1) -> Method:
    if method is None:
        method = "source_only" if cfg.dataset == "gtav" else "feature_adapt"
    check_ported(cfg, method)
    mesh = make_mesh(n_devices)
    if isinstance(mesh, IdleRank):
        raise ValueError(f"build_method: {mesh}")
    layout = make_layout(mesh, cfg.spatial_shard)
    pad_to = _step_pad_to(cfg, mesh.size)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    deeplab = DeepLab(num_classes=cfg.num_classes,
                      output_stride=cfg.out_stride, dtype=cfg.precision,
                      device=device, generator=generator,
                      freeze_bn=cfg.freeze_bn, backbone=cfg.backbone,
                      split_concat=cfg.split_concat,
                      logits_dtype=cfg.logits_dtype, remat=cfg.remat,
                      pad_stats=cfg.pad_stats)
    set_batchnorm_sync(deeplab, mesh)
    seg_loss_fn = build_seg_loss(cfg.loss_type, class_weights, mesh=mesh)
    lr_fn = make_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.epochs,
                             iters_per_epoch, cfg.lr_step, cfg.warmup_epochs)
    layout.unit = path_stride(deeplab, method)
    eval_step = make_eval_step(deeplab, seg_loss_fn, cfg.num_classes,
                               layout.rows_mesh(cfg.eval_spatial_shard),
                               layout.unit)

    def new_generator() -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            rank_seed(cfg.seed, mesh))

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
                                         seg_loss_fn, cfg.adv_softmax_axis,
                                         pad_to=pad_to, layout=layout)

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
                      aux_model=discr, mesh=mesh, layout=layout)

    # feature_adapt / source_only (train.py:47-82)
    domain = DomainClassifier(backbone=cfg.backbone, dtype=cfg.precision,
                              device=device, generator=generator)
    set_batchnorm_sync(domain, mesh)
    opt = make_optimizer(cfg.optimizer, cfg.momentum, cfg.weight_decay,
                         cfg.nesterov)
    step_fn = make_feature_adapt_step(deeplab, domain, opt, opt, opt, lr_fn,
                                      seg_loss_fn,
                                      source_only=(method == "source_only"),
                                      pad_to=pad_to, layout=layout)

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
                  aux_model=domain, mesh=mesh, layout=layout)
