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

Under data-parallel training (`mesh`, core/mesh.py, of more than one
process) every mean is the global batch's, as the JAX package's are under
a sharded batch (s2r_tpu/train/losses.py:14-17), and each loss returns
this rank's share of it: summed over the ranks, the shares are the loss
of the whole batch, and so are their gradients, which the step sums over
the ranks.  The cross-entropy all-reduces its normalizer (the summed
weights of the counted pixels, which carry no gradient); the focal loss
needs the global CE on every rank for its chain-rule factor and
all-reduces the detached CE; the plain means divide by the global count
of real elements, taken over the mesh (``real_count``: one all-reduce of
each rank's count, never its shape times the mesh's size).  Under a
spatial layout (core/mesh.py Layout) a rank holds a band of its data
row's samples' rows, short or empty past the image's end, and under
masked batch padding only its real samples: the world still counts
every real pixel once, so the same normalizers hold.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from s2r_tpu_torch.models.layers import relu


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = 255, mesh=None) -> torch.Tensor:
    """logits [N,C,H,W] (any float), labels [N,H,W] int.  Pixels whose label
    is outside [0, C), ignore_index among them, neither contribute nor enter
    the normalizer (the global batch's under `mesh`)."""
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
    den = w.sum()
    if _sharded(mesh):
        mesh.all_reduce_(den)
    return (nll * w).sum() / den.clamp(min=1e-12)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               weight: Optional[torch.Tensor] = None,
               ignore_index: int = 255, gamma: float = 2.0,
               alpha: Optional[float] = 0.5, mesh=None) -> torch.Tensor:
    """The reference's focal variant on the reduced CE scalar.  Under
    `mesh` the factor is taken at the global CE: this rank's share is
    focal(CE) / world with the gradient focal'(CE) * d(this rank's CE
    share)."""
    ce = cross_entropy(logits, labels, weight, ignore_index, mesh)
    if _sharded(mesh):
        ce_share = ce
        ce = mesh.all_reduce_(ce_share.detach().clone())
        ce = ce + (ce_share - ce_share.detach())
    logpt = -ce
    pt = torch.exp(logpt)
    if alpha is not None:
        logpt = logpt * alpha
    loss = -((1.0 - pt) ** gamma) * logpt
    if _sharded(mesh):
        loss = loss - loss.detach() * (1.0 - 1.0 / mesh.size)
    return loss


def build_seg_loss(mode: str, weight: Optional[torch.Tensor] = None,
                   ignore_index: int = 255, mesh=None):
    """The seg loss by name, 'ce' or 'focal', as (logits, labels) -> loss
    (this rank's share under `mesh`)."""
    if mode == "ce":
        return lambda logits, labels: cross_entropy(logits, labels, weight,
                                                    ignore_index, mesh)
    if mode == "focal":
        return lambda logits, labels: focal_loss(logits, labels, weight,
                                                 ignore_index, mesh=mesh)
    raise NotImplementedError(mode)


def real_count(x: torch.Tensor, mesh) -> Optional[torch.Tensor]:
    """The elements of x over every rank of `mesh` (a float64 device
    scalar, by one all-reduce), or None at one process."""
    if not _sharded(mesh):
        return None
    return mesh.all_reduce_(torch.full((1,), float(x.numel()),
                                       dtype=torch.float64,
                                       device=x.device))[0]


def _global_mean(x: torch.Tensor, mesh,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of x over every rank's x: this rank's share (x.mean() at
    one process).  `count`: real_count of a tensor of x's shape on every
    rank (None: taken here)."""
    if not _sharded(mesh):
        return x.mean()
    if count is None:
        count = real_count(x, mesh)
    return x.sum() / count.to(x.dtype)


def _const_label_ce(logits: torch.Tensor, label: int, mesh=None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    f = torch.promote_types(logits.dtype, torch.float32)
    return -_global_mean(F.log_softmax(logits.to(f), dim=1)[:, label], mesh,
                         count)


def domain_loss(src_logits: torch.Tensor, tgt_logits: torch.Tensor,
                mesh=None, count: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N,2,H,W] logits of each domain -> (src CE to 0 + tgt CE to 1,
    domain accuracy by the reference's formula); this rank's shares under
    `mesh` (`count`: real_count of an [N,H,W] map, when the caller has
    it)."""
    if src_logits.shape != tgt_logits.shape:
        raise ValueError(f"domain_loss: {tuple(src_logits.shape)} != "
                         f"{tuple(tgt_logits.shape)}")
    if count is None:
        count = real_count(src_logits[:, 0], mesh)
    loss = (_const_label_ce(src_logits, 0, mesh, count)
            + _const_label_ce(tgt_logits, 1, mesh, count))
    src_pred = src_logits.argmax(1)
    tgt_pred = tgt_logits.argmax(1)
    hits = ((1 - src_pred).sum() + tgt_pred.sum()).float() / 2.0
    if count is not None:
        return loss, hits / count.float()
    n, _, h, w = src_logits.shape
    return loss, hits / n / h / w


def bce_with_logits(logits: torch.Tensor, target: float, mesh=None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean BCE-with-logits against a constant target (0.0 or 1.0); this
    rank's share of the global mean under `mesh` (`count`: real_count of
    the logits, when the caller has it)."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    abs_x = torch.where(x >= 0, x, -x)  # jnp.abs's gradient: 1 at 0
    return _global_mean(relu(x) - x * float(target)
                        + torch.log1p(torch.exp(-abs_x)), mesh, count)
