"""The train steps of the three methods (s2r_tpu/train/steps.py), and the
eval step.

``make_output_adapt_step`` (steps.py:49-165), the output-space adaptation
step:
One call is one iteration of the reference's train_adapt.py:126-181: G
(DeepLab) forwards the source and then the target batch in train mode (the
BatchNorm running statistics update in that order); G is trained on the
source CE plus BCE(D(softmax(tgt)), source label) with D held constant,
and D on BCE(D(softmax(detached src)), 0) + BCE(D(softmax(detached tgt)),
1).  The adversarial softmax runs over the batch axis by default, the
reference's F.softmax(output, dim=0).  G steps with SGD under 1x
(backbone) / 10x (ASPP, decoder) learning rates, D with Adam; one
scheduler's rate drives both (train_adapt.py:133 overrides Adam's).

The JAX package partitions the gradients with stop_gradient on one joint
loss and shares D's target forward between two terms.  Here D's parameters
stop requiring gradients for the adversarial forward and the D terms see
detached maps, as in the reference, so one torch.autograd.grad over the
summed losses yields exactly G's and D's gradients; D runs three forwards,
so its first conv's kernel launches three times a step.  No value is read
back to the host inside the step.

``make_feature_adapt_step`` (steps.py:172-297) is one iteration of the
reference's train.py:181-211, the feature-space adaptation step: G
forwards the source batch, the domain classifier D its ASPP feature, then
G the target batch and D its feature, all in train mode and in that
order.  One gradient of task + d + d_inv over G and D; then the task
optimizer steps all of G, the d optimizer D, and the d_inv optimizer f =
backbone + ASPP again with the same f-gradient (its own buffers; weight
decay on the task-updated f).  No learning-rate groups.  With
`source_only` (train.py --dataset gtav) only the task loss and the task
optimizer run; D is not touched.

``make_eval_step`` is the validation step (s2r_tpu/train/steps.py:300): an
eval-mode forward of G, the seg loss on its float32 logits, the argmax and
the confusion matrix, all on G's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn

from s2r_tpu_torch.eval.metrics import confusion_matrix
from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                      discriminator_param_order,
                                      domain_param_order,
                                      feature_param_order)
from s2r_tpu_torch.train.losses import bce_with_logits, domain_loss
from s2r_tpu_torch.train.optim import FusedOptimizer
from s2r_tpu_torch.train.state import TrainState

SOURCE_LABEL = 0.0  # train_adapt.py:117
TARGET_LABEL = 1.0  # train_adapt.py:118


def _adv_softmax(logits: torch.Tensor, mode: str) -> torch.Tensor:
    """NCHW logits -> the map D sees: softmax over the batch axis
    ('batch', the reference's dim=0) or over the classes ('class')."""
    return torch.softmax(logits, dim=0 if mode == "batch" else 1)


def _ordered(module: nn.Module, names: List[str]) -> List[nn.Parameter]:
    params = dict(module.named_parameters())
    if sorted(params) != sorted(names):
        raise ValueError(f"{type(module).__name__}: parameters "
                         f"{sorted(set(params) ^ set(names))} do not match "
                         "the JAX package's layout")
    return [params[k] for k in names]


def segmenter_params(deeplab) -> Tuple[List[nn.Parameter], List[float]]:
    """DeepLab's parameters in the JAX flatten order, and their learning-
    rate multipliers: 1 for the backbone, 10 for ASPP and decoder
    (deeplab.py:42-72)."""
    names = deeplab_param_order(deeplab.backbone_name)
    return (_ordered(deeplab, names),
            [1.0 if k.startswith("backbone.") else 10.0 for k in names])


def discriminator_params(discriminator) -> List[nn.Parameter]:
    """The discriminator's parameters in the JAX flatten order."""
    return _ordered(discriminator, discriminator_param_order())


def domain_params(domain_cls) -> List[nn.Parameter]:
    """The domain classifier's parameters in the JAX flatten order."""
    return _ordered(domain_cls, domain_param_order())


def feature_params(deeplab) -> List[nn.Parameter]:
    """f = backbone + ASPP of DeepLab, in the JAX flatten order."""
    params = dict(deeplab.named_parameters())
    return [params[k] for k in feature_param_order(deeplab.backbone_name)]


def _no_pad(pad_to):
    if pad_to is not None:
        raise NotImplementedError("pad_to: batch padding is TPU-only and "
                                  "not ported")


def make_output_adapt_step(deeplab, discriminator, g_opt, d_opt,
                           lr_fn: Callable, seg_loss_fn: Callable,
                           adv_softmax_mode: str = "batch",
                           pad_to: int = None):
    """step(state, batch) -> (state, metrics) over `deeplab` (G) and
    `discriminator` (D), the modules `state` holds.

    batch: 'src_image', 'tgt_image' NHWC float, 'src_label' [N,H,W] int
    (tensors or arrays; moved to G's device).  metrics: 'seg_loss',
    'adv_loss', 'd_loss' and 'lr' as device tensors.  The modules are left
    in train mode.  Batch padding (`pad_to`) is not ported: it pays only on
    a TPU, where the JAX package pads the batch to the sublane width.
    """
    _no_pad(pad_to)
    if adv_softmax_mode not in ("batch", "class"):
        raise ValueError(f"adv_softmax_mode {adv_softmax_mode!r}")
    g_params, g_mult = segmenter_params(deeplab)
    d_params = discriminator_params(discriminator)
    fused_g = FusedOptimizer(g_opt, g_params, g_mult)
    fused_d = FusedOptimizer(d_opt, d_params)
    n_g = len(g_params)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = deeplab.device
        lr = float(lr_fn(state.step))
        src = torch.as_tensor(batch["src_image"], device=dev).permute(0, 3, 1, 2)
        tgt = torch.as_tensor(batch["tgt_image"], device=dev).permute(0, 3, 1, 2)
        label = torch.as_tensor(batch["src_label"], device=dev)
        deeplab.train()
        discriminator.train()
        src_logits, _ = deeplab(src, generator=state.generator)
        tgt_logits, _ = deeplab(tgt, generator=state.generator)
        l_seg = seg_loss_fn(src_logits, label)
        tp = _adv_softmax(tgt_logits, adv_softmax_mode)
        sp = _adv_softmax(src_logits.detach(), adv_softmax_mode)
        # G's adversarial term: D constant (train_adapt.py:140-155)
        for p in d_params:
            p.requires_grad_(False)
        try:
            l_adv = bce_with_logits(discriminator(tp), SOURCE_LABEL)
        finally:
            for p in d_params:
                p.requires_grad_(True)
        # D's terms on detached maps (train_adapt.py:157-178)
        l_d = (bce_with_logits(discriminator(sp), SOURCE_LABEL)
               + bce_with_logits(discriminator(tp.detach()), TARGET_LABEL))
        grads = torch.autograd.grad(l_seg + l_adv + l_d, g_params + d_params)
        state.opt_state = {
            "G": fused_g.apply(grads[:n_g], state.opt_state["G"], g_params, lr),
            "D": fused_d.apply(grads[n_g:], state.opt_state["D"], d_params, lr)}
        state.step += 1
        metrics = {"seg_loss": l_seg.detach(), "adv_loss": l_adv.detach(),
                   "d_loss": l_d.detach(),
                   "lr": torch.tensor(lr, dtype=torch.float32, device=dev)}
        return state, metrics

    return step


def make_feature_adapt_step(deeplab, domain_cls, task_opt, d_opt, d_inv_opt,
                            lr_fn: Callable, seg_loss_fn: Callable,
                            source_only: bool = False, pad_to: int = None):
    """step(state, batch) -> (state, metrics) over `deeplab` (G) and
    `domain_cls` (D), the modules `state` holds.

    batch: 'src_image', 'tgt_image' NHWC float and 'src_label' [N,H,W]
    int; with `source_only`, 'image' and 'label' (tensors or arrays; moved
    to G's device).  metrics: 'task_loss', 'd_loss', 'd_inv_loss', 'd_acc'
    and 'lr' as device tensors (the middle three zeros with
    `source_only`).  state.opt_state is {'task', 'd', 'd_inv', 'c'};
    'c' is carried and never stepped (train.py:202-204).  The modules are
    left in train mode.  Batch padding (`pad_to`) is not ported.
    """
    _no_pad(pad_to)
    g_params, _ = segmenter_params(deeplab)  # no 1x/10x groups here
    d_params = domain_params(domain_cls)
    f_params = feature_params(deeplab)
    fused_task = FusedOptimizer(task_opt, g_params)
    fused_d = FusedOptimizer(d_opt, d_params)
    fused_inv = FusedOptimizer(d_inv_opt, f_params)
    f_index = {id(p): i for i, p in enumerate(g_params)}
    f_at = [f_index[id(p)] for p in f_params]
    n_g = len(g_params)
    src_key, lbl_key = (("image", "label") if source_only
                        else ("src_image", "src_label"))

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = deeplab.device
        lr = float(lr_fn(state.step))
        src = torch.as_tensor(batch[src_key], device=dev).permute(0, 3, 1, 2)
        label = torch.as_tensor(batch[lbl_key], device=dev)
        gen = state.generator
        deeplab.train()
        src_out, src_feat = deeplab(src, generator=gen)
        task = seg_loss_fn(src_out, label)
        opt = dict(state.opt_state)
        if source_only:
            grads = torch.autograd.grad(task, g_params)
            opt["task"] = fused_task.apply(grads, opt["task"], g_params, lr)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            d_l = d_inv_l = d_acc = zero
        else:
            tgt = torch.as_tensor(batch["tgt_image"],
                                  device=dev).permute(0, 3, 1, 2)
            domain_cls.train()
            src_d = domain_cls(src_feat, generator=gen)
            _, tgt_feat = deeplab(tgt, generator=gen)
            tgt_d = domain_cls(tgt_feat, generator=gen)
            d_l, d_acc = domain_loss(src_d, tgt_d)
            d_inv_l, _ = domain_loss(tgt_d, src_d)
            grads = torch.autograd.grad(task + d_l + d_inv_l,
                                        g_params + d_params)
            # train.py:202-204, in torch's order: task over G, d over D,
            # then d_inv over the task-updated f with the same gradient
            opt["task"] = fused_task.apply(grads[:n_g], opt["task"],
                                           g_params, lr)
            opt["d"] = fused_d.apply(grads[n_g:], opt["d"], d_params, lr)
            opt["d_inv"] = fused_inv.apply([grads[i] for i in f_at],
                                           opt["d_inv"], f_params, lr)
        state.opt_state = opt
        state.step += 1
        metrics = {"task_loss": task.detach(), "d_loss": d_l.detach(),
                   "d_inv_loss": d_inv_l.detach(), "d_acc": d_acc.detach(),
                   "lr": torch.tensor(lr, dtype=torch.float32, device=dev)}
        return state, metrics

    return step


def make_eval_step(deeplab, seg_loss_fn: Callable, num_classes: int):
    """eval_step(image, label) -> (loss, cm, pred) on `deeplab`.

    image NHWC float, label [N,H,W] int (tensors or arrays; moved to G's
    device).  The forward runs in eval mode (running-statistics BatchNorm,
    no dropout) and the module's mode is restored after it.  loss is a
    float32 scalar, cm the [C, C] int64 confusion matrix and pred the
    [N,H,W] argmax, all on the device: nothing is read back to the host.
    """

    @torch.no_grad()
    def eval_step(image, label):
        dev = deeplab.device
        x = torch.as_tensor(image, device=dev).permute(0, 3, 1, 2)
        label = torch.as_tensor(label, device=dev)
        was_training = deeplab.training
        deeplab.eval()
        try:
            logits, _ = deeplab(x)
        finally:
            deeplab.train(was_training)
        loss = seg_loss_fn(logits, label)
        pred = logits.argmax(1)
        return loss, confusion_matrix(label, pred, num_classes), pred

    return eval_step
