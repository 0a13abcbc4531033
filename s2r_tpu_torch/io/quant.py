"""Post-training int8 quantization of the serving decoder tail.

The port of s2r_tpu/io/quant.py: the decoder head's two 3x3 convs
(``last_conv.0`` and ``last_conv.4``) run int8 x int8 -> int32 with their
BatchNorms folded into the weights; the backbone, ASPP, the low-level 1x1 and
the classifier stay in the model's compute dtype.

Scheme (symmetric linear):

    weights      q_W = round(W_folded / s_w) in [-127,127], s_w per output
                 channel = max|W_folded[..., c]| / 127
    activations  q_x = round(x / s_a) in [-127,127], s_a = calib_max / 127
                 (per tensor, from ``calibrate_decoder_int8``)
    conv         int8 x int8 -> exact int32: a shifted-slice im2col and
                 ``torch._int_mm`` (a plain matrix product, as the JAX
                 package leaves its int8 conv to XLA)
    requant      the hand-written kernel (ops/kernels/requant.py): int32 ->
                 int8 with the clamp to [0,127] as the ReLU before conv #2

The tail works NHWC between the two int8 convs, the layout the matrix
product produces.  int8 is not exact: use it only for serving
(io/serving.py ``quant="decoder_int8"``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from s2r_tpu_torch.data.normalize import normalize_rgb8
from s2r_tpu_torch.models.layers import BatchNorm, Conv2d, relu
from s2r_tpu_torch.ops.kernels.requant import requant_s32_to_s8
from s2r_tpu_torch.ops.resize import resize_bilinear_align_corners


def fold_bn(conv: Conv2d, bn: BatchNorm) -> Tuple[np.ndarray, np.ndarray]:
    """Fold an eval BatchNorm into the conv before it: (W*inv HWIO, shift)
    as float32 numpy, the arithmetic of s2r_tpu/io/quant.py fold_bn."""
    k = conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
    scale = bn.weight.detach().cpu().numpy()
    bias = bn.bias.detach().cpu().numpy()
    mean = bn.running_mean.cpu().numpy()
    var = bn.running_var.cpu().numpy()
    inv = scale / np.sqrt(var + np.float32(bn.eps))
    return k * inv, bias - mean * inv


def _quantize_weights(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: (q [kh,kw,I,O] int8, s_w [O] f32)."""
    s = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s = np.maximum(s, np.finfo(np.float32).tiny).astype(np.float32)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s


def _conv3x3_s8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 3x3 conv, padding 1: x int8 [N,H,W,C], w int8 [9C,O]
    ((dy,dx,c)-major, an HWIO kernel reshaped) -> int32 [N,H,W,O]."""
    n, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                      for dy in range(3) for dx in range(3)], dim=-1)
    return torch._int_mm(cols.view(-1, 9 * c), w).view(n, h, wd, -1)


def _oihw(w_hwio: np.ndarray, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1))).to(device, dtype)


def make_decoder_tail(decoder, *, scales: Dict[str, float],
                      compute_dtype: torch.dtype = torch.float32) -> Callable:
    """(ASPP feature [N,256,h,w], low-level [N,24,4h,4w]) -> decoder-
    resolution logits [N,classes,4h,4w] float32, with the two 3x3 head convs
    in int8.  `scales` {'a0', 'a1'} come from ``calibrate_decoder_int8``."""
    dev, cd = decoder.conv1.weight.device, compute_dtype
    lc = decoder.last_conv
    w_low, b_low = fold_bn(decoder.conv1, decoder.bn1)
    w0, b0 = fold_bn(lc[0], lc[1])
    w1, b1 = fold_bn(lc[4], lc[5])
    q0, sw0 = _quantize_weights(w0)
    q1, sw1 = _quantize_weights(w1)
    a0 = np.float32(scales["a0"])
    a1 = np.float32(scales["a1"])
    m0 = (a0 * sw0).astype(np.float32)
    m1 = (a1 * sw1).astype(np.float32)
    inv_a1 = np.float32(1.0 / a1)

    def dev_t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    w_low_t, b_low_t = _oihw(w_low, dev, cd), dev_t(b_low, cd).view(1, -1, 1, 1)
    q0_t = dev_t(q0.reshape(-1, q0.shape[-1]), torch.int8)
    q1_t = dev_t(q1.reshape(-1, q1.shape[-1]), torch.int8)
    m0_t, b0_t, m1_t, b1_t = dev_t(m0), dev_t(b0), dev_t(m1), dev_t(b1)
    kc = lc[8].weight.detach()[:, :, 0, 0].T.to(cd).float()  # [256, classes]
    bc = lc[8].bias.detach().float()
    a0f = float(a0)

    def quant_in(t: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(t.float() / a0f), -127, 127).to(torch.int8)

    def tail(feat: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        low = relu(F.conv2d(low.to(cd), w_low_t) + b_low_t)
        x = resize_bilinear_align_corners(feat, low.shape[-2:], dtype=cd)
        q = torch.cat([quant_in(x), quant_in(low)], dim=1)
        s32 = _conv3x3_s8(q.permute(0, 2, 3, 1).contiguous(), q0_t)
        q2 = requant_s32_to_s8(s32, m0_t, b0_t, inv_a1)
        s32 = _conv3x3_s8(q2, q1_t)
        z = relu(s32.float() * m1_t + b1_t).to(cd)
        logits = torch.matmul(z.float(), kc) + bc  # [N,h,w,classes]
        return logits.permute(0, 3, 1, 2)

    return tail


@torch.inference_mode()
def calibrate_decoder_int8(model, batches: Iterable, *,
                           input: str = "normalized") -> Dict[str, float]:
    """Activation scales {'a0', 'a1'} of the int8 tail from calibration
    images (NHWC; 'normalized' eval-transform float32, or 'rgb8' bytes).

    Runs the folded float32 decoder path and records the max magnitude of
    the 304-channel concat feeding last_conv.0 (a0) and of the ReLU output
    feeding last_conv.4 (a1); each scale is max/127.
    """
    dec = model.decoder
    dev = model.device
    w_low, b_low = fold_bn(dec.conv1, dec.bn1)
    w0, b0 = fold_bn(dec.last_conv[0], dec.last_conv[1])
    w_low_t, w0_t = _oihw(w_low, dev, torch.float32), _oihw(w0, dev, torch.float32)
    b_low_t = torch.from_numpy(b_low).to(dev).view(1, -1, 1, 1)
    b0_t = torch.from_numpy(b0).to(dev).view(1, -1, 1, 1)
    m0 = m1 = 0.0
    count = 0
    for batch in batches:
        image = torch.as_tensor(batch, device=dev)
        if input == "rgb8":
            image = normalize_rgb8(image)
        feat, low = model.taps(image.permute(0, 3, 1, 2))
        low = relu(F.conv2d(low.float(), w_low_t) + b_low_t)
        x = resize_bilinear_align_corners(feat, low.shape[-2:],
                                          dtype=torch.float32)
        y = torch.cat([x, low], dim=1)
        z = relu(F.conv2d(y, w0_t, padding=1) + b0_t)
        m0 = max(m0, float(y.abs().max()))
        m1 = max(m1, float(z.max()))
        count += 1
    if count == 0:
        raise ValueError("calibration needs at least one image batch")
    if m0 <= 0.0 or m1 <= 0.0:
        raise ValueError(f"degenerate calibration maxima ({m0}, {m1}): "
                         "are the calibration images all zero?")
    return {"a0": m0 / 127.0, "a1": m1 / 127.0}
