"""The experiment configuration and the CLI flag surface, copied from
s2r_tpu/config.py with the same field names, defaults, flags and dests.

The parser accepts every flag the JAX package's parser accepts.  A flag
whose feature the port lacks raises NotImplementedError, naming the flag
and the ROADMAP item, when it is set to anything but its default
(``check_ported``); ``--batch-pad auto`` means off, as it does off a TPU,
and ``--prng-impl`` (a JAX setting) is read and ignored, except that a
JAX-format checkpoint the port writes carries a dropout key of that
implementation (io/convert.py ``jax_rng``).  ``--data-backend native``
takes the native loader with ``--dataset gtav2cityscapes``: the JAX
package has it in that arm alone and loads ``gtav`` and ``synthetic`` on
its PIL path whatever the flag says (s2r_tpu/data/loader.py:130-176), and
so does the port (data/loader.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # --- model ---
    backbone: str = "mobilenet"
    out_stride: int = 16
    num_classes: int = 19
    freeze_bn: bool = False
    sync_bn: Optional[bool] = None  # BatchNorm is always synchronized
    # over the data-parallel ranks, as in the JAX package

    # --- dataset / paths ---
    dataset: str = "gtav2cityscapes"  # or 'gtav', 'synthetic'
    src_img_root: str = ""
    src_label_root: str = ""
    tgt_img_root: str = ""
    val_img_root: str = ""
    val_label_root: str = ""
    test_img_root: str = ""
    test_label_root: str = ""
    workers: int = 4
    base_size: int = 512
    crop_size: int = 512
    data_backend: str = "pil"
    # flip / scale-crop / blur / normalize on the device (data/device_aug.py)
    device_aug: bool = False

    # --- loss ---
    loss_type: str = "ce"  # 'ce' | 'focal'
    use_balanced_weights: bool = False
    no_d_loss: bool = False

    # --- training hyper-parameters ---
    epochs: int = 200
    start_epoch: int = 0
    batch_size: int = 4
    test_batch_size: int = 1
    optimizer: str = "SGD"
    lr: float = 5e-4
    lr_scheduler: str = "poly"  # 'poly' | 'step' | 'cos'
    lr_step: int = 0
    warmup_epochs: int = 0
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False

    # --- devices / precision ---
    num_devices: Optional[int] = None
    batch_pad: str = "auto"  # 'auto' | 'off': both off here (TPU-only)
    data_cache: bool = False
    data_cache_gb: float = 32.0
    # 'bf16' compute / f32 params, or 'f32'; the port adds 'f64' for
    # reference runs on the CPU (core/device.py).
    precision: str = "bf16"
    pad_stats: bool = True
    remat: bool = False
    seed: int = 1
    prng_impl: str = "rbg"  # a JAX setting; ignored by the port

    # --- observability ---
    profile_dir: Optional[str] = None

    # --- checkpointing ---
    resume: Optional[str] = None
    backbone_init: Optional[str] = None
    checkname: Optional[str] = None
    ft: bool = True  # reference default: optimizer state NOT restored
    run_root: str = "run"
    async_save: bool = True

    # --- evaluation ---
    eval_interval: int = 1
    no_val: bool = False
    eval_spatial_shard: bool = False
    spatial_shard: int = 1
    logits_dtype: str = "f32"
    split_concat: bool = False

    # --- faithful-quirk switches ---
    # F.softmax(output, dim=0) over the batch axis feeding the output-space
    # discriminator (reference train_adapt.py:151,166,174): 'batch' is the
    # faithful setting, 'class' the per-pixel class softmax.
    adv_softmax_axis: str = "batch"
    # drop_last=True on val/test loaders drops tail images (reference
    # dataloders/__init__.py:12-13)
    val_drop_last: bool = True

    def __post_init__(self):
        if self.checkname is None:
            self.checkname = "deeplab-" + str(self.backbone)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        d = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# (field, flag, the values the port runs, ROADMAP item) of every feature
# the port lacks: none now.
_UNPORTED = ()


# The training methods (s2r_tpu/train/setup.py build_method).
METHODS = ("output_adapt", "feature_adapt", "source_only")


def check_ported(cfg: Config, method: Optional[str] = None) -> None:
    """Raise NotImplementedError for a setting whose feature the port
    lacks, naming the flag and the ROADMAP item, and ValueError for a
    method that does not exist."""
    for field, flag, ok, item in _UNPORTED:
        value = getattr(cfg, field)
        if value not in ok:
            raise NotImplementedError(
                f"s2r_tpu_torch: {flag} {value!r} is not ported (ROADMAP "
                f"{item})")
    if method is not None and method not in METHODS:
        raise ValueError(f"s2r_tpu_torch: unknown method {method!r}; the "
                         f"methods are {', '.join(METHODS)}")


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y")


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    """Register the shared flag surface: the JAX package's flags, names,
    defaults and dests (s2r_tpu/config.py:171)."""
    d = Config()
    p = parser
    p.add_argument("--backbone", type=str, default=d.backbone,
                   choices=["mobilenet", "resnet", "resnet101", "resnet50",
                            "xception", "drn"])
    p.add_argument("--out-stride", type=int, default=d.out_stride, dest="out_stride")
    p.add_argument("--dataset", type=str, default=d.dataset,
                   choices=["gtav2cityscapes", "gtav", "synthetic"])
    p.add_argument("--src_img_root", type=str, default=d.src_img_root)
    p.add_argument("--src_label_root", type=str, default=d.src_label_root)
    p.add_argument("--tgt_img_root", type=str, default=d.tgt_img_root)
    p.add_argument("--val_img_root", type=str, default=d.val_img_root)
    p.add_argument("--val_label_root", type=str, default=d.val_label_root)
    p.add_argument("--test_img_root", type=str, default=d.test_img_root)
    p.add_argument("--test_label_root", type=str, default=d.test_label_root)
    p.add_argument("--workers", type=int, default=d.workers, metavar="N")
    p.add_argument("--data-backend", type=str, default=d.data_backend,
                   choices=["pil", "native"], dest="data_backend")
    p.add_argument("--device-aug", action="store_true",
                   default=d.device_aug, dest="device_aug")
    p.add_argument("--base-size", type=int, default=d.base_size, dest="base_size")
    p.add_argument("--crop-size", type=int, default=d.crop_size, dest="crop_size")
    p.add_argument("--sync-bn", type=_str2bool, default=None, dest="sync_bn")
    p.add_argument("--freeze-bn", type=_str2bool, default=d.freeze_bn, dest="freeze_bn")
    p.add_argument("--loss-type", type=str, default=d.loss_type,
                   choices=["ce", "focal"], dest="loss_type")
    p.add_argument("--no_d_loss", type=_str2bool, default=d.no_d_loss)
    p.add_argument("--epochs", type=int, default=d.epochs, metavar="N")
    p.add_argument("--optimizer", type=str, default=d.optimizer)
    p.add_argument("--start_epoch", type=int, default=d.start_epoch, metavar="N")
    p.add_argument("--batch-size", type=int, default=d.batch_size, dest="batch_size")
    p.add_argument("--test-batch-size", type=int, default=d.test_batch_size,
                   dest="test_batch_size")
    p.add_argument("--lr", type=float, default=d.lr, metavar="LR")
    p.add_argument("--lr-scheduler", type=str, default=d.lr_scheduler,
                   choices=["poly", "step", "cos"], dest="lr_scheduler")
    p.add_argument("--lr-step", type=int, default=d.lr_step, dest="lr_step",
                   help="epochs per 0.1x decay for --lr-scheduler step")
    p.add_argument("--warmup-epochs", type=int, default=d.warmup_epochs,
                   dest="warmup_epochs",
                   help="linear LR warmup epochs (0 = off)")
    p.add_argument("--momentum", type=float, default=d.momentum, metavar="M")
    p.add_argument("--weight-decay", type=float, default=d.weight_decay,
                   dest="weight_decay", metavar="M")
    p.add_argument("--nesterov", action="store_true", default=d.nesterov)
    p.add_argument("--use_balanced_weights", action="store_true",
                   default=d.use_balanced_weights)
    p.add_argument("--num-devices", type=int, default=None, dest="num_devices",
                   help="data-parallel width: the number of processes "
                        "torchrun starts (one per device)")
    p.add_argument("--batch-pad", type=str, default=d.batch_pad,
                   dest="batch_pad", choices=["auto", "off"],
                   help="TPU-only batch padding: both values mean off here")
    p.add_argument("--data-cache", action="store_true", dest="data_cache",
                   default=d.data_cache,
                   help="memoize decoded frames on the train path (no "
                        "effect on --dataset synthetic)")
    p.add_argument("--data-cache-gb", type=float, default=d.data_cache_gb,
                   dest="data_cache_gb")
    p.add_argument("--precision", type=str, default=d.precision,
                   choices=["bf16", "f32"])
    p.add_argument("--remat", action="store_true", dest="remat",
                   default=d.remat)
    p.add_argument("--fast-pad-stats", action="store_false", dest="pad_stats",
                   default=d.pad_stats)
    p.add_argument("--seed", type=int, default=d.seed, metavar="S")
    p.add_argument("--prng-impl", type=str, default=d.prng_impl,
                   choices=["rbg", "threefry2x32", "unsafe_rbg"],
                   dest="prng_impl",
                   help="a JAX setting: the port draws dropout masks from a "
                        "torch.Generator, and writes a key of this "
                        "implementation into JAX-format checkpoints")
    p.add_argument("--resume", type=str, default=None,
                   help="a checkpoint: the port's, the JAX package's "
                        "msgpack .ckpt or a reference .pth/.pth.tar; or "
                        "'auto'")
    p.add_argument("--backbone-init", type=str, default=None,
                   dest="backbone_init",
                   help="a torch state dict of --backbone to initialize "
                        "the backbone (reference: mobilenet_VOC.pth; "
                        "resnet: torchvision's layout)")
    p.add_argument("--profile-dir", type=str, default=None,
                   dest="profile_dir")
    p.add_argument("--checkname", type=str, default=None)
    p.add_argument("--ft", action="store_true", default=d.ft)
    p.add_argument("--eval-interval", type=int, default=d.eval_interval,
                   dest="eval_interval")
    p.add_argument("--eval-spatial-shard", action="store_true",
                   default=d.eval_spatial_shard, dest="eval_spatial_shard")
    p.add_argument("--spatial-shard", type=int, default=d.spatial_shard,
                   dest="spatial_shard")
    p.add_argument("--logits-dtype", type=str, default=d.logits_dtype,
                   choices=["f32", "bf16"], dest="logits_dtype")
    p.add_argument("--split-concat", action="store_true",
                   default=d.split_concat, dest="split_concat")
    p.add_argument("--no-val", action="store_true", default=d.no_val, dest="no_val")
    p.add_argument("--no-async-save", action="store_false", dest="async_save",
                   default=d.async_save,
                   help="write checkpoints synchronously in the train loop")
    p.add_argument("--run-root", type=str, default=d.run_root, dest="run_root")
    p.add_argument("--adv-softmax-axis", type=str, default=d.adv_softmax_axis,
                   choices=["batch", "class"], dest="adv_softmax_axis")
    p.add_argument("--no-val-drop-last", action="store_false",
                   dest="val_drop_last", default=d.val_drop_last,
                   help="evaluate the tail val/test batch too")


def config_from_args(args: argparse.Namespace) -> Config:
    """The Config of parsed flags; raises for a flag the port lacks."""
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in known})
    check_ported(cfg)
    return cfg
