"""Serving: an image batch in, labels, logits or probabilities out.

The port of s2r_tpu/io/serving.py ``make_serving_fn``: the same arguments,
validation and results.  Images are NHWC, as in the JAX package; the model
runs NCHW on a channels-last view of them.  The StableHLO artifact
(export_servable/load_servable) has no counterpart yet.

Float32 convs on the card follow PyTorch's ``torch.backends.cudnn.allow_tf32``
(True by default: TF32); a caller that needs float32 convs sets it False.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from s2r_tpu_torch.data.normalize import normalize_rgb8
from s2r_tpu_torch.ops.argmax import argmax_first
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners

_OUTPUTS = ("labels", "logits", "probs")


def _nearest_ac_indices(out_size: int, in_size: int) -> np.ndarray:
    """Align-corners nearest-neighbour gather indices (out_size,), copied
    from s2r_tpu/io/serving.py: output i samples input i*(in-1)/(out-1)
    rounded half up (floor(x + 0.5), not rint, so integer upsample ratios
    give an even grid)."""
    if out_size == 1:
        return np.zeros((1,), np.int64)
    scale = (in_size - 1) / (out_size - 1)
    return np.floor(np.arange(out_size) * scale + 0.5).astype(np.int64)


def make_serving_fn(model, *, output: str = "labels",
                    input: str = "normalized",
                    argmax_res: str = "full",
                    label_dtype: str = "int32",
                    quant: str = "none",
                    quant_scales: Optional[dict] = None,
                    pad_batch_to: Optional[int] = None) -> Callable:
    """Closure over `model` (models.deeplab.DeepLab): NHWC image batch ->
    prediction on the model's device.

    output: 'labels' ([N,H,W] trainIds), 'logits' (float32 [N,H,W,C]) or
    'probs' (softmax, float32).  input: 'normalized' (eval-transform
    float32) or 'rgb8' (raw bytes, normalized on the device).
    argmax_res (labels only): 'full' (upsample the logits, then argmax) or
    'decoder' (argmax at stride 4, then nearest-upsample the labels on the
    align-corners grid).  label_dtype (labels only): 'int32' or 'uint8'.
    quant: 'none' (exact) or 'decoder_int8' (io/quant.py; needs
    `quant_scales` from ``calibrate_decoder_int8``).
    pad_batch_to: zero-pad the batch to this size, run, and slice back.
    """
    if pad_batch_to is not None and pad_batch_to < 1:
        raise ValueError("pad_batch_to must be >= 1")
    if quant not in ("none", "decoder_int8"):
        raise ValueError("quant must be 'none' or 'decoder_int8'")
    if quant != "none" and not (quant_scales and "a0" in quant_scales
                                and "a1" in quant_scales):
        raise ValueError("quant='decoder_int8' needs quant_scales from "
                         "s2r_tpu_torch.io.quant.calibrate_decoder_int8")
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {_OUTPUTS}")
    if input not in ("normalized", "rgb8"):
        raise ValueError("input must be 'normalized' or 'rgb8'")
    if argmax_res not in ("full", "decoder"):
        raise ValueError("argmax_res must be 'full' or 'decoder'")
    if argmax_res == "decoder" and output != "labels":
        raise ValueError("argmax_res='decoder' only applies to "
                         "output='labels'")
    if label_dtype not in ("int32", "uint8"):
        raise ValueError("label_dtype must be 'int32' or 'uint8'")
    if label_dtype == "uint8" and output != "labels":
        raise ValueError("label_dtype='uint8' only applies to "
                         "output='labels'")
    if label_dtype == "uint8" and model.num_classes > 256:
        raise ValueError("label_dtype='uint8' needs num_classes <= 256")
    out_dtype = torch.int32 if label_dtype == "int32" else torch.uint8
    dev = model.device
    tail = None
    if quant != "none":
        from s2r_tpu_torch.io.quant import make_decoder_tail

        tail = make_decoder_tail(model.decoder, scales=quant_scales,
                                 compute_dtype=model.compute_dtype)

    @torch.inference_mode()
    def fn(image):
        image = torch.as_tensor(image, device=dev)
        full_hw = tuple(image.shape[1:3])
        n_real = image.shape[0]
        if pad_batch_to is not None:
            if n_real > pad_batch_to:
                raise ValueError(f"batch {n_real} exceeds "
                                 f"pad_batch_to={pad_batch_to}")
            if n_real < pad_batch_to:
                image = torch.cat([image, image.new_zeros(
                    (pad_batch_to - n_real,) + tuple(image.shape[1:]))])
        if input == "rgb8":
            image = normalize_rgb8(image)
        x = image.permute(0, 3, 1, 2)
        if tail is not None:
            feat, low = model.taps(x)
            logits = tail(feat, low)  # decoder resolution, float32
            if output != "labels" or argmax_res == "full":
                logits = resize_bilinear_align_corners(logits, full_hw,
                                                       dtype=torch.float32)
        else:
            logits, _ = model(x, upsample_logits=argmax_res == "full")
            logits = logits.float()
        if output == "labels":
            labels = argmax_first(logits, dim=1).to(out_dtype)
            if argmax_res == "decoder":
                # cast before the gather: the full-res pass moves bytes
                rows = torch.from_numpy(
                    _nearest_ac_indices(full_hw[0], labels.shape[1])).to(dev)
                cols = torch.from_numpy(
                    _nearest_ac_indices(full_hw[1], labels.shape[2])).to(dev)
                labels = labels.index_select(1, rows).index_select(2, cols)
            return labels[:n_real]
        logits = logits[:n_real].permute(0, 2, 3, 1)
        if output == "probs":
            return torch.softmax(logits, dim=-1)
        return logits.contiguous()

    return fn
