"""Output-space adaptation training driver (s2r_tpu/cli/train_adapt.py,
reference train_adapt.py): DeepLab segmenter and fully-convolutional
discriminator on the softmax maps, with per-epoch validation, best-mIoU
checkpoints and resume.  The flags are the JAX package's.

    python -m s2r_tpu_torch.cli.train_adapt --dataset gtav2cityscapes \\
        --src_img_root GTA5/images --src_label_root GTA5/labels \\
        --tgt_img_root cityscapes/leftImg8bit/train \\
        --val_img_root cityscapes/leftImg8bit/val \\
        --val_label_root cityscapes/gtFine/val \\
        --test_img_root cityscapes/leftImg8bit/test \\
        --epochs 50 --batch-size 8 --crop-size 512 --base-size 512

The roots are flat directories of PNG files, read without PIL
(data/datasets.py); ``--device-aug`` augments on the card, ``--data-cache``
keeps decoded frames in memory; ``--dataset synthetic`` needs no files.

Runs on the card; ``S2R_PLATFORM=cpu`` selects the CPU.
"""

from __future__ import annotations

import argparse

from s2r_tpu_torch.config import add_common_flags, config_from_args
from s2r_tpu_torch.core.device import device_from_env
from s2r_tpu_torch.train.trainer import Trainer


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="s2r_tpu_torch output-space adaptation training")
    add_common_flags(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    trainer = Trainer(cfg, method="output_adapt", device=device_from_env())
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
