"""JAX/flax variables of DeepLab (MobileNetV2) -> the port's state_dict.

``from_jax_variables(params, batch_stats)`` takes the flax-style nested dicts
of numpy arrays that ``DeepLab.init`` produces (or a checkpoint holds) and
returns the reference torch key schema, the one s2r_tpu/io/torch_export.py
``export_deeplab`` writes: ``backbone.features.N.conv.j`` with its
``low_level_features``/``high_level_features`` aliases, ``aspp.aspp{k}``,
``aspp.global_avg_pool.{1,2}``, ``decoder.last_conv.{0,1,4,5,8}``.  The
result loads into ``models.deeplab.DeepLab`` with ``strict=True``.

Layouts: conv kernels HWIO -> OIHW (a depthwise [3,3,1,C] becomes
[C,1,3,3]); BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var, plus the num_batches_tracked buffer torch expects.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from s2r_tpu_torch.models.mobilenet import LOW_LEVEL_SPLIT, block_plan


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(out: Dict, key: str, leaf: Mapping) -> None:
    out[f"{key}.weight"] = _t(np.transpose(np.asarray(leaf["kernel"]),
                                           (3, 2, 0, 1)))
    if "bias" in leaf:
        out[f"{key}.bias"] = _t(leaf["bias"])


def _bn(out: Dict, key: str, p: Mapping, s: Mapping) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _backbone(out: Dict, p: Mapping, s: Mapping, output_stride: int) -> None:
    feats: Dict = {}
    _conv(feats, "features.0.0", p["features_0_conv"])
    _bn(feats, "features.0.1", p["features_0_bn"], s["features_0_bn"])
    for i, (_, _, _, _, t) in enumerate(block_plan(output_stride)):
        name, key = f"features_{i + 1}", f"features.{i + 1}.conv"
        subs = ("dw_conv", "dw_bn", None, "project_conv", "project_bn")
        if t != 1:
            subs = ("expand_conv", "expand_bn", None) + subs
        for j, sub in enumerate(subs):
            if sub is None:  # ReLU6: no parameters
                continue
            if sub.endswith("_bn"):
                _bn(feats, f"{key}.{j}", p[name][sub], s[name][sub])
            else:
                _conv(feats, f"{key}.{j}", p[name][sub])
    for k, v in feats.items():
        idx, rest = k[len("features."):].split(".", 1)
        alias = ("low_level_features" if int(idx) <= LOW_LEVEL_SPLIT
                 else "high_level_features")
        out[f"backbone.{k}"] = v
        out[f"backbone.{alias}.{idx}.{rest}"] = v


def _aspp(out: Dict, p: Mapping, s: Mapping) -> None:
    for k in range(1, 5):
        _conv(out, f"aspp.aspp{k}.atrous_conv", p[f"aspp{k}"]["atrous_conv"])
        _bn(out, f"aspp.aspp{k}.bn", p[f"aspp{k}"]["bn"], s[f"aspp{k}"]["bn"])
    _conv(out, "aspp.global_avg_pool.1", p["gap_conv"])
    _bn(out, "aspp.global_avg_pool.2", p["gap_bn"], s["gap_bn"])
    _conv(out, "aspp.conv1", p["conv1"])
    _bn(out, "aspp.bn1", p["bn1"], s["bn1"])


def _decoder(out: Dict, p: Mapping, s: Mapping) -> None:
    _conv(out, "decoder.conv1", p["conv1"])
    _bn(out, "decoder.bn1", p["bn1"], s["bn1"])
    _conv(out, "decoder.last_conv.0", p["last_conv_0"])
    _bn(out, "decoder.last_conv.1", p["last_bn_0"], s["last_bn_0"])
    _conv(out, "decoder.last_conv.4", p["last_conv_1"])
    _bn(out, "decoder.last_conv.5", p["last_bn_1"], s["last_bn_1"])
    _conv(out, "decoder.last_conv.8", p["classifier"])


def from_jax_variables(params: Mapping, batch_stats: Mapping,
                       output_stride: int = 16) -> Dict[str, torch.Tensor]:
    """{'backbone','aspp','decoder'} params and batch_stats (nested dicts of
    numpy arrays) -> float32 CPU state_dict in the reference schema."""
    out: Dict[str, torch.Tensor] = {}
    _backbone(out, params["backbone"], batch_stats["backbone"], output_stride)
    _aspp(out, params["aspp"], batch_stats["aspp"])
    _decoder(out, params["decoder"], batch_stats["decoder"])
    return out
