"""Serving: an image batch in, labels, logits or probabilities out.

The port of s2r_tpu/io/serving.py: ``make_serving_fn`` with the same
arguments, validation and results, and a servable artifact of the port's
own in place of the JAX package's StableHLO one (``export_servable``,
``load_servable``, ``Servable``).  Images are NHWC, as in the JAX package;
the model runs NCHW on a channels-last view of them.

Servable layout: the 8-byte magic ``S2RTRCH1`` (the JAX artifact's is
``S2RSHLO1``), a little-endian u64 length, a JSON meta block with the JAX
meta's keys (``format`` naming the port's format) plus the compute
``precision``, then the float32 weights of the segmenter as ``torch.save``
writes its state_dict, read back with ``weights_only=True``.  The artifact
holds weights, not compiled code: ``load_servable`` rebuilds DeepLab on
the card and serves through ``make_serving_fn``, so the hand-written
depthwise and requant kernels run.  Its call refuses another input shape
than the exported one, as a fixed-shape JAX export does (with
``batch_polymorphic`` only N may differ), and a JAX ``.shlo`` raises: the
port cannot run StableHLO.

Float32 convs on the card follow PyTorch's ``torch.backends.cudnn.allow_tf32``
(True by default: TF32); a caller that needs float32 convs sets it False.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from s2r_tpu_torch.data.normalize import normalize_rgb8
from s2r_tpu_torch.utils.tree import map_tensors
from s2r_tpu_torch.ops.argmax import argmax_first
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners

_OUTPUTS = ("labels", "logits", "probs")
MAGIC = b"S2RTRCH1"
JAX_MAGIC = b"S2RSHLO1"
FORMAT = "s2r_tpu_torch.servable"
PLATFORMS = ("cuda", "cpu")


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


def export_servable(model, input_shape: Sequence[int], path: str, *,
                    output: str = "labels", input: str = "normalized",
                    argmax_res: str = "full", label_dtype: str = "int32",
                    quant: str = "none",
                    quant_scales: Optional[dict] = None,
                    pad_batch_to: Optional[int] = None,
                    platforms: Optional[Sequence[str]] = None,
                    batch_polymorphic: bool = False,
                    meta: Optional[dict] = None) -> dict:
    """Write `model`'s (models.deeplab.DeepLab) weights and the serving
    options to `path`; returns the meta written in the header.

    input_shape: [N, H, W, 3], the shape the servable accepts (any N with
    `batch_polymorphic`).  platforms: the devices it is meant for, 'cuda'
    and/or 'cpu' (default: the model's device type), recorded only.  The
    other options are make_serving_fn's, checked by building it here."""
    platforms = list(platforms or [model.device.type])
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad}: the port serves on "
                         f"{', '.join(PLATFORMS)}")
    if len(input_shape) != 4 or input_shape[3] != 3:
        raise ValueError(f"input_shape {list(input_shape)}: want [N, H, W, 3]")
    make_serving_fn(model, output=output, input=input, argmax_res=argmax_res,
                    label_dtype=label_dtype, quant=quant,
                    quant_scales=quant_scales, pad_batch_to=pad_batch_to)
    precision = {torch.float32: "f32", torch.bfloat16: "bf16",
                 torch.float64: "f64"}[model.compute_dtype]
    info = {"format": FORMAT, "output": output, "input": input,
            "argmax_res": argmax_res, "label_dtype": label_dtype,
            "quant": quant,
            "quant_requant": "kernel" if quant != "none" else None,
            "pad_batch_to": pad_batch_to,
            "quant_scales": ({k: float(v) for k, v in quant_scales.items()}
                             if quant != "none" else None),
            "input_shape": [int(d) for d in input_shape],
            "input_dtype": "uint8" if input == "rgb8" else "float32",
            "batch_polymorphic": bool(batch_polymorphic),
            "platforms": platforms, "backbone": model.backbone_name,
            "output_stride": model.output_stride,
            "num_classes": model.num_classes,
            "normalization": ("baked-in (raw RGB8 in)" if input == "rgb8"
                              else "(x/255 - IMAGENET_MEAN) / IMAGENET_STD"),
            "precision": precision}
    if meta:
        info.update(meta)
    weights = io.BytesIO()  # one copy per storage: the aliases stay aliases
    torch.save(map_tensors(model.state_dict(),
                           lambda t: t.detach().to("cpu", copy=True)),
               weights)
    payload = json.dumps(info).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(payload)))
        f.write(payload)
        f.write(weights.getbuffer())
    os.replace(tmp, path)
    return info


@dataclasses.dataclass
class Servable:
    """A loaded servable: ``serve(images)`` runs on the model's device and
    returns what make_serving_fn returns (a tensor on that device)."""
    meta: dict
    model: torch.nn.Module
    fn: Callable

    def __call__(self, images):
        shape = list(images.shape)
        want = list(self.meta["input_shape"])
        if self.meta["batch_polymorphic"]:
            shape[0] = want[0] = "N"
        if shape != want:
            raise ValueError(f"servable input shape {list(images.shape)}: "
                             f"the artifact takes {want}")
        dtype = str(images.dtype).replace("torch.", "")
        if dtype != self.meta["input_dtype"]:
            raise ValueError(f"servable input dtype {dtype}: the artifact "
                             f"takes {self.meta['input_dtype']}")
        return self.fn(images)


def read_servable(path: str):
    """(meta, state_dict on the CPU) of a servable of the port."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path} is a StableHLO artifact of the JAX package "
                "(jax.export); the port cannot run StableHLO: export a "
                "servable with python -m s2r_tpu_torch.cli.export")
        if magic != MAGIC:
            raise ValueError(f"{path}: not a servable of s2r_tpu_torch "
                             f"(bad magic {magic!r})")
        (n,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(n).decode())
        weights = torch.load(io.BytesIO(f.read()), map_location="cpu",
                             weights_only=True)
    return meta, weights


def load_servable(path: str,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Servable:
    """Rebuild the servable's DeepLab (the backbone and output stride of
    its meta) on `device` (``cuda`` when None) and its serving function."""
    from s2r_tpu_torch.models.deeplab import DeepLab

    meta, weights = read_servable(path)
    model = DeepLab(num_classes=meta["num_classes"],
                    output_stride=meta["output_stride"],
                    dtype=meta["precision"], device=device,
                    backbone=meta.get("backbone", "mobilenet"))
    model.load_state_dict(weights, strict=True)
    fn = make_serving_fn(model, output=meta["output"], input=meta["input"],
                         argmax_res=meta["argmax_res"],
                         label_dtype=meta["label_dtype"],
                         quant=meta["quant"],
                         quant_scales=meta["quant_scales"],
                         pad_batch_to=meta["pad_batch_to"])
    return Servable(meta, model, fn)
