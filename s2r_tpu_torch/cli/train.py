"""Feature-space adaptation and source-only training driver
(s2r_tpu/cli/train.py, reference train.py): `--dataset gtav` trains the
segmenter alone on the source (source-only); any other dataset trains it
with the pixel-wise domain classifier on the summed task + d + d_inv loss
(feature_adapt).  Per-epoch validation, best-mIoU checkpoints and resume;
the flags are the JAX package's.

    python -m s2r_tpu_torch.cli.train --dataset gtav \\
        --src_img_root GTA5/images --src_label_root GTA5/labels \\
        --epochs 50 --batch-size 8 --crop-size 512 --base-size 512

``--dataset gtav2cityscapes`` takes the roots of train_adapt; ``synthetic``
needs none.  Runs on the card; ``S2R_PLATFORM=cpu`` selects the CPU.
"""

from __future__ import annotations

import argparse

from s2r_tpu_torch.config import add_common_flags, config_from_args
from s2r_tpu_torch.core.device import device_from_env
from s2r_tpu_torch.train.trainer import Trainer


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="s2r_tpu_torch feature-space adaptation training")
    add_common_flags(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    method = "source_only" if cfg.dataset == "gtav" else "feature_adapt"
    trainer = Trainer(cfg, method=method, device=device_from_env())
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
