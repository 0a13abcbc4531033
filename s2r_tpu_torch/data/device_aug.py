"""Training augmentation on the device (s2r_tpu/data/device_aug.py).

The reference runs RandomHorizontalFlip -> RandomScaleCrop -> Blur ->
Normalize in PIL on its loader workers (custom_transforms.py).  Here the
host ships raw uint8 frames and the batch's device does the rest as one
warp per sample: random flip, short edge scaled to U{0.5 .. 2} x base_size,
pad (image 0, label 255) and a crop_size crop, all one bilinear (image) /
nearest (label) gather of the staged frame, then a p = 0.5 Gaussian blur
(radius U(0, 1), independent for each image of the pair) and ImageNet
normalization.  The float32 arithmetic is the JAX package's: the
center-aligned affine, the two-stage bilinear gather (rows, then columns),
zero fill before the blur, the 9-tap edge-extended separable blur, and
``(x / 255 - mean) / std``.

Sampling is split from the warp.  ``sample_params`` draws each sample's
flip, short edge, crop corner, blur gate and two radii from a CPU
``torch.Generator`` (a handful of scalars a sample); ``warp_paired_batch``
and ``warp_batch`` apply them on the frames' device.  The same seed gives
the same augmented batch on the card and on the CPU, and JAX's sampled
parameters can be fed to the port's warp.  ``batch_generator`` seeds the
sampler from (seed, epoch) as s2r_tpu/train/trainer.py:260 does and from
the batch index, so a resumed epoch sees the same views.  Under
data-parallel training each rank draws the global batch's rows and keeps
its own (``rank::world``, the loader's slice), so every sample gets the
views it gets on one device.

PIL's downscale filter is an area-weighted triangle, not bilinear
sampling, so this path matches the reference's distribution of augmented
views, not its pixels (as in the JAX package).
"""

from __future__ import annotations

from typing import Dict

import torch

from s2r_tpu_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD

_BLUR_TAPS = 4  # +-4 px: 3.5 sigma at the largest radius (sigma < 1)
_F32 = torch.float32


def _crop_hw(crop_size) -> tuple:
    """crop_size int (square, the reference's semantics) or (h, w)."""
    if isinstance(crop_size, (tuple, list)):
        return int(crop_size[0]), int(crop_size[1])
    return int(crop_size), int(crop_size)


def batch_generator(seed: int, epoch: int, index: int) -> torch.Generator:
    """The CPU generator of batch `index` of `epoch`."""
    epoch_seed = (seed, epoch).__hash__() & 0x7FFFFFFF
    return torch.Generator().manual_seed(
        (epoch_seed, index).__hash__() & 0x7FFFFFFFFFFFFFFF)


def sample_params(generator: torch.Generator, n: int, base_size: int,
                  crop_size, sh: int, sw: int, process_index: int = 0,
                  process_count: int = 1) -> Dict[str, torch.Tensor]:
    """Random flip / scale / crop / blur parameters of `n` samples whose
    staged frames are sh x sw, as CPU tensors: 'flip' and 'blur_gate'
    bool [n]; the scaled frame 'oh', 'ow' and the crop corner 'y1', 'x1'
    float32 [n]; 'radius' float32 [n, 2] (one for each image of a pair).
    With `process_count` W > 1, `n` is this rank's share of a global
    batch of n * W: the rows of all n * W are drawn and rows
    process_index::W kept.

    RandomScaleCrop's math (custom_transforms.py:114-143): the short edge
    scaled to U{b/2 .. 2b}, the frame padded right and bottom up to the
    crop, the corner uniform over the padded extent.
    """
    if process_count > 1:
        p = sample_params(generator, n * process_count, base_size,
                          crop_size, sh, sw)
        return {k: v[process_index::process_count] for k, v in p.items()}
    ch, cw = _crop_hw(crop_size)
    g = generator
    flip = torch.rand(n, generator=g) < 0.5
    short = torch.randint(base_size // 2, 2 * base_size + 1, (n,),
                          generator=g).to(_F32)
    shf, swf = torch.tensor(sh, dtype=_F32), torch.tensor(sw, dtype=_F32)
    if sh > sw:
        oh, ow = torch.floor(shf * short / swf), short
    else:
        oh, ow = short, torch.floor(swf * short / shf)
    pad_h = torch.clamp(oh, min=float(ch))
    pad_w = torch.clamp(ow, min=float(cw))
    u = torch.rand((2, n), generator=g)
    y1 = torch.floor(u[0] * (pad_h - ch + 1.0))
    x1 = torch.floor(u[1] * (pad_w - cw + 1.0))
    blur_gate = torch.rand(n, generator=g) < 0.5
    radius = torch.rand((n, 2), generator=g)
    return {"flip": flip, "oh": oh, "ow": ow, "y1": y1, "x1": x1,
            "blur_gate": blur_gate, "radius": radius}


def _gaussian_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian of per-sample sigma [N] (PIL's GaussianBlur
    radius ~ sigma), edge-extended like PIL.  x [N, H, W, C] float32."""
    offs = torch.arange(-_BLUR_TAPS, _BLUR_TAPS + 1, dtype=_F32,
                        device=x.device)
    w = torch.exp(-0.5 * (offs / torch.clamp(sigma, min=1e-4)[:, None]) ** 2)
    w = w / w.sum(dim=1, keepdim=True)
    taps = [w[:, k, None, None, None] for k in range(2 * _BLUR_TAPS + 1)]
    h, wd = x.shape[1], x.shape[2]
    rows = torch.arange(-_BLUR_TAPS, h + _BLUR_TAPS,
                        device=x.device).clamp(0, h - 1)
    xp = x[:, rows]
    x = sum(t * xp[:, k:k + h] for k, t in enumerate(taps))
    cols = torch.arange(-_BLUR_TAPS, wd + _BLUR_TAPS,
                        device=x.device).clamp(0, wd - 1)
    xp = x[:, :, cols]
    return sum(t * xp[:, :, k:k + wd] for k, t in enumerate(taps))


class _Warp:
    """The crop's source coordinates for a batch of staged sh x sw frames."""

    def __init__(self, p: Dict[str, torch.Tensor], sh: int, sw: int,
                 crop_size, device):
        ch, cw = _crop_hw(crop_size)
        p = {k: v.to(device) for k, v in p.items()}
        self.p, self.sh, self.sw = p, sh, sw
        n = p["oh"].shape[0]
        self.n_idx = torch.arange(n, device=device)[:, None]
        ys = p["y1"][:, None] + torch.arange(ch, dtype=_F32, device=device)
        xs = p["x1"][:, None] + torch.arange(cw, dtype=_F32, device=device)
        self.inside = ((ys[:, :, None] < p["oh"][:, None, None])
                       & (xs[:, None, :] < p["ow"][:, None, None]))
        # center-aligned affine into the staged frame, like PIL's filters;
        # sh / oh as a division (a scalar over a tensor would multiply by
        # the reciprocal in torch, off by an ulp at exact halves)
        self.src_y = (ys + 0.5) * (torch.full_like(p["oh"], sh)
                                   / p["oh"])[:, None] - 0.5
        src_x = (xs + 0.5) * (torch.full_like(p["ow"], sw)
                              / p["ow"])[:, None] - 0.5
        self.src_x = torch.where(p["flip"][:, None], (sw - 1.0) - src_x,
                                 src_x)
        self.rows = torch.arange(ch, device=device)[None, :, None]

    def bilinear(self, frame: torch.Tensor) -> torch.Tensor:
        """[N, SH, SW, C] -> [N, ch, cw, C] float32: rows, then columns."""
        sh, sw = self.sh, self.sw
        y0 = torch.clamp(torch.floor(self.src_y), 0, sh - 1)
        x0 = torch.clamp(torch.floor(self.src_x), 0, sw - 1)
        y1i = torch.clamp(y0 + 1, 0, sh - 1).long()
        x1i = torch.clamp(x0 + 1, 0, sw - 1).long()
        wy = torch.clamp(self.src_y - y0, 0.0, 1.0)[:, :, None, None]
        wx = torch.clamp(self.src_x - x0, 0.0, 1.0)[:, None, :, None]
        f = frame.to(_F32)
        top = f[self.n_idx, y0.long()]     # [N, ch, SW, C]
        bot = f[self.n_idx, y1i]
        row = top * (1 - wy) + bot * wy
        n3 = self.n_idx[:, :, None]
        left = row[n3, self.rows, x0.long()[:, None, :]]
        right = row[n3, self.rows, x1i[:, None, :]]
        return left * (1 - wx) + right * wx

    def nearest_label(self, frame: torch.Tensor) -> torch.Tensor:
        """[N, SH, SW] -> [N, ch, cw] int64; 255 in the padding."""
        yn = torch.clamp(torch.round(self.src_y), 0, self.sh - 1).long()
        xn = torch.clamp(torch.round(self.src_x), 0, self.sw - 1).long()
        lbl = frame[self.n_idx[:, :, None], yn[:, :, None],
                    xn[:, None, :]].long()
        return torch.where(self.inside, lbl, torch.full_like(lbl, 255))

    def image(self, frame: torch.Tensor, which: int, blur: bool
              ) -> torch.Tensor:
        # the reference's order: the pad fill (0) comes before the blur and
        # the normalization, so padded pixels end up at (0 - mean) / std
        # and the blur smears the pad's edge
        raw = torch.where(self.inside[..., None], self.bilinear(frame),
                          torch.zeros((), dtype=_F32, device=frame.device))
        if blur:
            blurred = _gaussian_blur(raw, self.p["radius"][:, which])
            raw = torch.where(self.p["blur_gate"][:, None, None, None],
                              blurred, raw)
        return _normalize(raw)


def _normalize(raw: torch.Tensor) -> torch.Tensor:
    """0..255 float32 -> (x / 255 - mean) / std."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=_F32, device=raw.device)
    std = torch.tensor(IMAGENET_STD, dtype=_F32, device=raw.device)
    # 255 as a tensor on the device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which would move the card off the CPU
    scale = torch.full((), 255.0, dtype=_F32, device=raw.device)
    return (raw / scale - mean) / std


def warp_paired_batch(batch: Dict[str, torch.Tensor],
                      params: Dict[str, torch.Tensor], crop_size,
                      blur: bool = True) -> Dict[str, torch.Tensor]:
    """{'src_image' u8 [N,SH,SW,3], 'tgt_image' u8 [N,TH,TW,3],
    'src_label' u8/int [N,SH,SW]} -> {'src_image', 'tgt_image' float32
    [N,c,c,3], 'src_label' int64 [N,c,c]} on the batch's device.  The pair
    shares the flip, the scaled extent (oh, ow: drawn from the source
    frame's shape), the crop corner and the blur gate; the blur radii are
    independent.  Each frame maps onto that extent from its own size, as
    the PIL path resizes every entry to the source's (ow, oh): a target of
    another size than the source is read across its whole frame, where the
    JAX package's ``_warp_one`` takes the source's size for both and clamps
    (ROADMAP C.9)."""
    src, tgt = batch["src_image"], batch["tgt_image"]
    warp = _Warp(params, src.shape[1], src.shape[2], crop_size, src.device)
    tgt_warp = warp if tgt.shape[1:3] == src.shape[1:3] else _Warp(
        params, tgt.shape[1], tgt.shape[2], crop_size, tgt.device)
    return {"src_image": warp.image(src, 0, blur),
            "tgt_image": tgt_warp.image(tgt, 1, blur),
            "src_label": warp.nearest_label(batch["src_label"])}


def warp_batch(batch: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], crop_size,
               blur: bool = True) -> Dict[str, torch.Tensor]:
    """The single-domain (GTA5) variant on {'image', 'label'}."""
    img = batch["image"]
    warp = _Warp(params, img.shape[1], img.shape[2], crop_size, img.device)
    return {"image": warp.image(img, 0, blur),
            "label": warp.nearest_label(batch["label"])}


def augment_paired_batch(batch: Dict[str, torch.Tensor],
                         generator: torch.Generator, base_size: int,
                         crop_size, blur: bool = True, process_index: int = 0,
                         process_count: int = 1) -> Dict[str, torch.Tensor]:
    """Sample on the CPU from `generator` (this rank's rows of the global
    batch, ``sample_params``), then warp on the device."""
    n, sh, sw = batch["src_image"].shape[:3]
    params = sample_params(generator, n, base_size, crop_size, sh, sw,
                           process_index, process_count)
    return warp_paired_batch(batch, params, crop_size, blur)


def augment_batch(batch: Dict[str, torch.Tensor], generator: torch.Generator,
                  base_size: int, crop_size, blur: bool = True,
                  process_index: int = 0, process_count: int = 1
                  ) -> Dict[str, torch.Tensor]:
    n, sh, sw = batch["image"].shape[:3]
    params = sample_params(generator, n, base_size, crop_size, sh, sw,
                           process_index, process_count)
    return warp_batch(batch, params, crop_size, blur)


def normalize_u8_batch(batch: Dict) -> Dict:
    """Finish a uint8 batch on its device: images to (x / 255 - mean) / std
    float32, labels to int64; other values pass through."""
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v):
            out[k] = v
        elif "label" in k:
            out[k] = v.long()
        elif v.dtype == torch.uint8:
            out[k] = _normalize(v.to(_F32))
        else:
            out[k] = v
    return out
