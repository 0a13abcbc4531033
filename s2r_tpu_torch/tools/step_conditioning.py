"""How far float32 rounding alone moves the gradient of one output-space
adaptation step, leaf by leaf.

    python -m s2r_tpu_torch.tools.step_conditioning [--device cuda]
        [--sizes 64x2 128x2] [--affine]

For each size HxW batch N the step runs from seeded weights (BatchNorm
running statistics perturbed; scale and bias too with --affine), dropout
off, once in float32 on `device` and once in float64 on the CPU
(precision 'f64', the float32-rounding-free reference).  G's gradient per
leaf is read from SGD's momentum buffer after the step.  Prints, per size,
the global relative L2 distance of the float32 gradient from the float64
one, the median and worst leaf, and how many leaves the float64 gradient
leaves at zero up to rounding.

The weights are drawn on the CPU in module order, so every copy built
from the same seeds agrees; chip_smoke.py builds its models the same way.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from s2r_tpu_torch.config import Config
from s2r_tpu_torch.io.convert import deeplab_param_order
from s2r_tpu_torch.models.layers import BatchNorm, set_dropout
from s2r_tpu_torch.train.setup import build_method


def perturb_batchnorm(model: torch.nn.Module, stats_seed: int,
                      affine_seed: Optional[int] = None) -> None:
    """Running mean ~ N(0, 0.1) and var ~ U(0.5, 1.5) from `stats_seed`;
    with `affine_seed`, scale ~ U(0.5, 1.5) and bias ~ N(0, 0.1) too.

    At the initial scale 1 and bias 0 every block's input has a batch mean
    of exactly 0, so each expand BatchNorm's shift is 0 in exact
    arithmetic and fill = relu6(shift) sits on the kink: the gradient of
    those channels is then decided by the sign of rounding error, in any
    implementation.  Away from that point the step is a smooth function.
    """
    gen = torch.Generator().manual_seed(stats_seed)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in bns:
            c = m.num_features
            m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
        if affine_seed is not None:
            gen = torch.Generator().manual_seed(affine_seed)
            for m in bns:
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)


@torch.no_grad()
def warm_batchnorm(model: torch.nn.Module, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics of `model` to the batch
    statistics of `images` ([N,3,H,W] on the model's device): one
    train-mode forward at momentum 1 with dropout off; the model is left
    in eval mode with its momenta and counters as they were.  A
    random-weight ResNet, Xception or DRN with random running statistics
    grows its eval activations by orders of magnitude over the residual
    stages (logits of 1e6-1e9); warmed, an eval forward stays near unit
    scale layer by layer, as a trained model's does."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [(m.momentum, m.num_batches_tracked.clone()) for m in bns]
    for m in bns:
        m.momentum = 1.0
    set_dropout(model, False)
    try:
        model.train()(images)
    finally:
        model.eval()
        set_dropout(model, True)
        for m, (momentum, count) in zip(bns, saved):
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)


def sgd_gradients(buf: torch.Tensor, before: Dict[str, torch.Tensor],
                  weight_decay: float, prev: Optional[torch.Tensor] = None,
                  momentum: float = 0.0, order: Optional[List[str]] = None
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """The gradient of one SGD step, per leaf of `order` (the buffer's
    leaves; G's JAX flatten order when None), as
    float64 CPU tensors, from the flat momentum buffer after the step
    (`buf`, float32: momentum * prev + g + weight_decay * p) and the one
    before it (`prev`; None for a first step), with `before` the parameters
    before the step.  A leaf whose gradient the buffer does not resolve
    (norm within 100 float32 roundings of the buffer's) maps to None: its
    gradient is zero up to rounding.  (A leaf whose parameters are all 0
    leaves g alone in the buffer and so always counts as resolved.)"""
    buf = buf.double().cpu()
    prev = torch.zeros_like(buf) if prev is None else prev.double().cpu()
    out, at = {}, 0
    for k in deeplab_param_order() if order is None else order:
        p = before[k].double().cpu().reshape(-1)
        b = buf[at:at + p.numel()]
        g = b - momentum * prev[at:at + p.numel()] - weight_decay * p
        at += p.numel()
        resolved = float(g.norm()) > 100 * 2.0 ** -24 * float(b.norm())
        out[k] = g if resolved else None
    if at != buf.numel():
        raise ValueError("momentum buffer and its leaves disagree")
    return out


def step_grads(precision: str, device, batch, affine: bool, seed: int = 0):
    """G's first-step gradient per leaf (sgd_gradients) of the step
    built from seed `seed`, dropout off."""
    method = build_method(Config(precision=precision), iters_per_epoch=1000,
                          method="output_adapt", device=device,
                          generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(method.deeplab, seed + 1, seed + 2 if affine else None)
    set_dropout(method.deeplab, False)
    state = method.init_state()
    before = {k: v.detach().clone()
              for k, v in method.deeplab.named_parameters()}
    state, _ = method.step_fn(state, batch)
    return sgd_gradients(state.opt_state["G"]["momentum"], before,
                         Config().weight_decay)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", nargs="+", default=["64x2"],
                    help="HxN: H x H crops, batch N")
    ap.add_argument("--affine", action="store_true")
    a = ap.parse_args()
    for size in a.sizes:
        hw, n = (int(v) for v in size.split("x"))
        rs = np.random.RandomState(0)
        label = rs.randint(0, 19, (n, hw, hw)).astype(np.int64)
        label[:, :3] = 255
        batch = {"src_image": rs.randn(n, hw, hw, 3).astype(np.float32),
                 "src_label": label,
                 "tgt_image": rs.randn(n, hw, hw, 3).astype(np.float32)}
        g32 = step_grads("f32", a.device, batch, a.affine)
        g64 = step_grads("f64", "cpu", batch, a.affine)
        kept = [k for k in g64 if g64[k] is not None]
        rel = {k: float((g32[k] - g64[k]).norm() / g64[k].norm())
               for k in kept}
        flat32, flat64 = (torch.cat([g[k] for k in kept]) for g in (g32, g64))
        worst = max(rel, key=rel.get)
        print(f"{hw}x{hw} batch {n}{' affine' if a.affine else ''} on "
              f"{a.device}: global {float((flat32 - flat64).norm() / flat64.norm()):.3g}; "
              f"leaves median {statistics.median(rel.values()):.3g}, worst "
              f"{rel[worst]:.3g} ({worst}); zero up to rounding "
              f"{len(g64) - len(kept)}", flush=True)


if __name__ == "__main__":
    main()
