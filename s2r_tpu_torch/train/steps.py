"""The output-space adaptation train step (s2r_tpu/train/steps.py:49-165).

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
                                      discriminator_param_order)
from s2r_tpu_torch.train.losses import bce_with_logits
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
    names = deeplab_param_order(deeplab.output_stride)
    return (_ordered(deeplab, names),
            [1.0 if k.startswith("backbone.") else 10.0 for k in names])


def discriminator_params(discriminator) -> List[nn.Parameter]:
    """The discriminator's parameters in the JAX flatten order."""
    return _ordered(discriminator, discriminator_param_order())


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
    if pad_to is not None:
        raise NotImplementedError("pad_to: batch padding is TPU-only and "
                                  "not ported")
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
