"""Loss functions on NCHW logits (s2r_tpu/train/losses.py).

- ``cross_entropy``: pixel CE with ignore_index=255, optional class weights,
  torch's 'mean' reduction: the weighted mean divides by the summed weights
  of the counted pixels.
- ``focal_loss``: the reference's variant built on the already reduced CE
  scalar: logpt = -CE; loss = -(1 - pt)^gamma * alpha * logpt.
- ``domain_loss``: 2-class per-pixel CE with constant labels (source 0,
  target 1), returning (loss, domain accuracy).
- ``bce_with_logits``: mean of max(x, 0) - x*z + log1p(exp(-|x|)) against a
  constant target, with the JAX package's subgradients at x = 0 (1/2 for
  the max, 1 for |x|: -z in all).

All reductions run in float32 (float64 inputs stay float64).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from s2r_tpu_torch.models.layers import relu


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = 255) -> torch.Tensor:
    """logits [N,C,H,W] (any float), labels [N,H,W] int.  Pixels whose label
    is outside [0, C), ignore_index among them, neither contribute nor enter
    the normalizer."""
    c = logits.shape[1]
    f = torch.promote_types(logits.dtype, torch.float32)
    labels = labels.long()
    valid = (labels >= 0) & (labels < c) & (labels != ignore_index)
    labels_c = labels.clamp(0, c - 1)
    logp = F.log_softmax(logits.to(f), dim=1)
    nll = -logp.gather(1, labels_c.unsqueeze(1)).squeeze(1)
    if weight is not None:
        w = weight.to(device=logits.device, dtype=f)[labels_c]
    else:
        w = torch.ones_like(nll)
    w = w * valid.to(f)
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               weight: Optional[torch.Tensor] = None,
               ignore_index: int = 255, gamma: float = 2.0,
               alpha: Optional[float] = 0.5) -> torch.Tensor:
    """The reference's focal variant on the reduced CE scalar."""
    ce = cross_entropy(logits, labels, weight, ignore_index)
    logpt = -ce
    pt = torch.exp(logpt)
    if alpha is not None:
        logpt = logpt * alpha
    return -((1.0 - pt) ** gamma) * logpt


def build_seg_loss(mode: str, weight: Optional[torch.Tensor] = None,
                   ignore_index: int = 255):
    """The seg loss by name, 'ce' or 'focal', as (logits, labels) -> loss."""
    if mode == "ce":
        return lambda logits, labels: cross_entropy(logits, labels, weight,
                                                    ignore_index)
    if mode == "focal":
        return lambda logits, labels: focal_loss(logits, labels, weight,
                                                 ignore_index)
    raise NotImplementedError(mode)


def _const_label_ce(logits: torch.Tensor, label: int) -> torch.Tensor:
    f = torch.promote_types(logits.dtype, torch.float32)
    return -F.log_softmax(logits.to(f), dim=1)[:, label].mean()


def domain_loss(src_logits: torch.Tensor, tgt_logits: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N,2,H,W] logits of each domain -> (src CE to 0 + tgt CE to 1,
    domain accuracy by the reference's formula)."""
    if src_logits.shape != tgt_logits.shape:
        raise ValueError(f"domain_loss: {tuple(src_logits.shape)} != "
                         f"{tuple(tgt_logits.shape)}")
    loss = _const_label_ce(src_logits, 0) + _const_label_ce(tgt_logits, 1)
    n, _, h, w = src_logits.shape
    src_pred = src_logits.argmax(1)
    tgt_pred = tgt_logits.argmax(1)
    acc = ((1 - src_pred).sum() + tgt_pred.sum()).float() / 2.0 / n / h / w
    return loss, acc


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean BCE-with-logits against a constant target (0.0 or 1.0)."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    abs_x = torch.where(x >= 0, x, -x)  # jnp.abs's gradient: 1 at 0
    return (relu(x) - x * float(target)
            + torch.log1p(torch.exp(-abs_x))).mean()
