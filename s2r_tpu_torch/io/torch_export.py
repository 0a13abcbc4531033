"""The port's modules -> reference torch checkpoints (s2r_tpu/io/
torch_export.py ``save_reference_checkpoint``), the inverse of
io/torch_import.py.

- ``single`` (train_adapt.py:204-209): {'state_dict': DeepLab's state_dict
  (MobileNetV2's with the backbone aliases), 'optimizer': {}, 'epoch',
  'best_pred'};
- ``four`` (train.py:242-253): the backbone's, ASPP's and the decoder's
  state_dicts without their prefixes, the domain classifier's
  ``DC_adnn*`` keys (empty unless a feature-method state gives one), four
  empty optimizer dicts, 'epoch' and 'best_pred'.

The optimizer dicts are empty, as the JAX package writes them.  The port's
state_dicts already hold the reference keys in its layouts (OIHW convs,
every BatchNorm's num_batches_tracked), so the tensors are written as they
are, each storage once.  Every backbone writes its own schema, the one
s2r_tpu/io/torch_export.py ``export_any_backbone`` writes for it
(io/convert.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from s2r_tpu_torch.utils.tree import map_tensors


def _host(sd: Dict[str, torch.Tensor], strip: str = "") -> Dict:
    """CPU copies of the entries under `strip` (the prefix removed), one
    copy per storage so the aliases stay aliases."""
    picked = {k[len(strip):]: v for k, v in sd.items() if k.startswith(strip)}
    return map_tensors(picked, lambda t: t.detach().to("cpu", copy=True))


def save_reference_checkpoint(path: str, G: torch.nn.Module,
                              D: Optional[torch.nn.Module] = None,
                              epoch: int = 0, best_pred: float = 0.0,
                              schema: str = "single",
                              backbone: Optional[str] = None) -> None:
    """Write a reference-format .pth.tar of the segmenter `G` (and, for
    ``four``, the domain classifier `D` when given).  `backbone`, when
    given, is the schema the caller expects: it must be `G`'s."""
    if backbone is not None and backbone != G.backbone_name:
        raise ValueError(f"backbone {backbone!r}: the model is a "
                         f"{G.backbone_name!r} DeepLab")
    sd = G.state_dict()
    if schema == "single":
        ckpt = {"state_dict": _host(sd), "optimizer": {},
                "epoch": int(epoch), "best_pred": float(best_pred)}
    elif schema == "four":
        ckpt = {"backbone_model_state_dict": _host(sd, "backbone."),
                "assp_model_state_dict": _host(sd, "aspp."),
                "y_model_state_dict": _host(sd, "decoder."),
                "d_model_state_dict": (_host(D.state_dict()) if D is not None
                                       else {}),
                "task_optimizer": {}, "d_optimizer": {},
                "d_inv_optimizer": {}, "c_optimizer": {},
                "epoch": int(epoch), "best_pred": float(best_pred)}
    else:
        raise ValueError(schema)
    torch.save(ckpt, path)
