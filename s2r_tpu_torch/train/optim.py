"""Optimizers with torch's update rules (s2r_tpu/train/optim.py).

torch SGD (momentum mu, weight_decay wd, nesterov):
    d    = grad + wd * p
    buf  = mu * buf + d              (a zero buffer before the first step)
    step = d + mu * buf   if nesterov else   buf
    p   <- p - lr * step

torch Adam (b1, b2, eps, wd):
    d  = grad + wd * p
    m  = b1 * m + (1-b1) * d ;  v = b2 * v + (1-b2) * d^2
    p <- p - lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)

The learning rate multiplies only the final direction, so the reference's
1x/10x groups are a per-leaf multiplier applied last.  Weight decay applies
to every leaf, BatchNorm parameters and biases included, as in the JAX
package.  Bias corrections are computed in float32 on the host.

``make_optimizer`` is the reference's ``--optimizer`` switch of the
feature method (train.py:63-82).

``SGD``/``Adam`` hold the update rules on lists of tensors (``init``,
``direction``), in float32 (float64 for float64 parameters: the reference
runs of tools/dist_check.py).  ``FusedOptimizer`` runs them on one flat
float32 buffer
over the leaves in the order it is given (the JAX package's flatten order,
from io/convert.py) and writes the new values into the parameters in
place.  Its buffers hold the leaves in the JAX package's order, each in
the port's layout (a conv kernel is OIHW here, HWIO there), so carrying
a JAX optimizer state across converts each leaf as its parameter is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_f = np.float32


def _f32up(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or float64 when it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    t = _f(count)
    return float(_f(1.0) - _f(b1) ** t), float(_f(1.0) - _f(b2) ** t)


@dataclasses.dataclass(frozen=True)
class SGD:
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"momentum": [torch.zeros_like(_f32up(p)) for p in params]}

    def direction(self, grads, state, params
                  ) -> Tuple[List[torch.Tensor], Dict]:
        """(step directions to be scaled by lr, new state)."""
        steps, bufs = [], []
        for g, buf, p in zip(grads, state["momentum"], params):
            d = _f32up(g)
            if self.weight_decay:
                d = d + self.weight_decay * _f32up(p)
            new_buf = self.momentum * buf + d
            steps.append(d + self.momentum * new_buf if self.nesterov
                         else new_buf)
            bufs.append(new_buf)
        return steps, {"momentum": bufs}


@dataclasses.dataclass(frozen=True)
class Adam:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"m": [torch.zeros_like(_f32up(p)) for p in params],
                "v": [torch.zeros_like(_f32up(p)) for p in params],
                "count": 0}

    def direction(self, grads, state, params
                  ) -> Tuple[List[torch.Tensor], Dict]:
        count = state["count"] + 1
        bc1, bc2 = _bias_corrections(self.b1, self.b2, count)
        steps, ms, vs = [], [], []
        for g, m, v, p in zip(grads, state["m"], state["v"], params):
            d = _f32up(g)
            if self.weight_decay:
                d = d + self.weight_decay * _f32up(p)
            m_new = self.b1 * m + (1.0 - self.b1) * d
            v_new = self.b2 * v + (1.0 - self.b2) * d * d
            steps.append((m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps))
            ms.append(m_new)
            vs.append(v_new)
        return steps, {"m": ms, "v": vs, "count": count}


def make_optimizer(name: str, momentum: float, weight_decay: float,
                   nesterov: bool):
    """'SGD' (momentum, weight decay, nesterov) or 'Adam': torch.optim.Adam
    built with the learning rate alone, so its default betas (0.9, 0.999)
    and no weight decay (s2r_tpu/train/optim.py:108-117)."""
    if name == "SGD":
        return SGD(momentum=momentum, weight_decay=weight_decay,
                   nesterov=nesterov)
    if name == "Adam":
        return Adam()
    raise NotImplementedError(f"--optimizer {name!r}")


class FusedOptimizer:
    """SGD or Adam over one flat float32 buffer of `params`, in their order
    (float64 for float64 parameters).

    `lr_mult` gives one multiplier per parameter (None: all 1).  ``apply``
    takes the gradients in the same order, returns the new optimizer state
    and writes the updated values into the parameters in place.
    """

    def __init__(self, opt, params: Sequence[torch.Tensor],
                 lr_mult: Optional[Sequence[float]] = None):
        if not isinstance(opt, (SGD, Adam)):
            raise TypeError(f"FusedOptimizer: unknown optimizer {opt!r}")
        self.opt = opt
        self.sizes = [p.numel() for p in params]
        dev = params[0].device if params else torch.device("cpu")
        self.mult = None
        if lr_mult is not None:
            if len(lr_mult) != len(self.sizes):
                raise ValueError("FusedOptimizer: one lr_mult per parameter")
            self.mult = torch.cat([torch.full((n,), float(m)) for n, m
                                   in zip(self.sizes, lr_mult)]).to(dev)

    def _flat(self, tensors) -> torch.Tensor:
        tensors = list(tensors)
        dtype = (torch.float64 if tensors and tensors[0].dtype == torch.float64
                 else torch.float32)
        return torch.cat([t.reshape(-1).to(dtype) for t in tensors])

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return _unwrap(self.opt.init([self._flat(params)]))

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: Dict,
              params: Sequence[torch.Tensor], lr: float) -> Dict:
        p = self._flat(params)
        steps, new_state = self.opt.direction(
            [self._flat(grads)], {k: [v] if torch.is_tensor(v) else v
                                  for k, v in state.items()}, [p])
        step = steps[0]
        if self.mult is not None:
            step = step * self.mult
        new = p - float(lr) * step
        for param, value in zip(params, new.split(self.sizes)):
            param.copy_(value.view_as(param))
        return _unwrap(new_state)


def _unwrap(state: Dict) -> Dict:
    """A one-leaf list state -> the flat-buffer state."""
    return {k: v[0] if isinstance(v, list) else v for k, v in state.items()}
