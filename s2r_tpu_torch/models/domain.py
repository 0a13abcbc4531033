"""The feature-space pixel-wise domain classifier (s2r_tpu/models/domain.py,
reference modeling/domian.py:7-47).

It reads the 256-channel ASPP output: 1x1 conv -> 1024 + BatchNorm + ReLU +
Dropout(0.5), 3x3 conv -> 1024 + BatchNorm + ReLU + Dropout(0.5), 3x3 conv
-> 2 logits (source / target) with a bias, per spatial position.  The
parameters carry the reference key schema (``DC_adnn1.0`` conv,
``DC_adnn1.1`` BatchNorm, ``DC_adnn2.0``, ``DC_adnn2.1``, ``DC_adnn3``;
s2r_tpu/io/torch_export.py ``export_domain``).

In train mode both BatchNorms run on the hand-written train-mode kernels
(models/layers.py ``BatchNorm``); the dense convs are cuDNN's, as the JAX
package leaves them to XLA.  Weights follow the port's ``init_weights``
(kaiming normal kernels, the torch default bias), drawn from an explicit
``torch.Generator``; parameters stay float32 and the module computes in
its compute dtype, casting its input first as the JAX package's Conv2d
does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from s2r_tpu_torch.core.device import resolve_device, resolve_dtype
from s2r_tpu_torch.models.layers import (BatchNorm, Conv2d, Dropout,
                                         init_weights, relu)

# (JAX parameter name, torch key, kind) of each layer with parameters;
# kind as io/convert.py reads it: 'conv', 'conv_bias' or 'bn'.
DOMAIN_LAYOUT = (("adnn1_conv", "DC_adnn1.0", "conv"),
                 ("adnn1_bn", "DC_adnn1.1", "bn"),
                 ("adnn2_conv", "DC_adnn2.0", "conv"),
                 ("adnn2_bn", "DC_adnn2.1", "bn"),
                 ("adnn3_conv", "DC_adnn3", "conv_bias"))


class DomainClassifier(nn.Module):
    def __init__(self, backbone: str = "mobilenet", level: str = "high", *,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # Any backbone: the input is always the 256-channel ASPP output.
        # Another tap level would need another input, and stays
        # unimplemented, as in the JAX package.
        if level != "high":
            raise NotImplementedError((backbone, level))
        device = resolve_device(device)
        self.compute_dtype = resolve_dtype(dtype)
        self.DC_adnn1 = nn.Sequential(Conv2d(256, 1024, 1), BatchNorm(1024))
        self.DC_adnn2 = nn.Sequential(Conv2d(1024, 1024, 3, padding=1),
                                      BatchNorm(1024))
        self.DC_adnn3 = Conv2d(1024, 2, 3, padding=1, bias=True)
        self.drop1, self.drop2 = Dropout(0.5), Dropout(0.5)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.DC_adnn3.weight.device

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [N, 256, h, w] -> domain logits [N, 2, h, w] in the compute
        dtype.  In train mode `generator` draws the dropout masks."""
        y = x.to(self.compute_dtype)
        y = self.drop1(relu(self.DC_adnn1[1](self.DC_adnn1[0](y))), generator)
        y = self.drop2(relu(self.DC_adnn2[1](self.DC_adnn2[0](y))), generator)
        return self.DC_adnn3(y)
