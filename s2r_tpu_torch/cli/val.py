"""Validation sweep of a checkpoint (s2r_tpu/cli/val.py, reference val.py):
each image's prediction saved as a labelId and a color PNG with its mIoU
(unless --skip-sep), then the aggregate per-class IoU report appended to
val_info.txt.  The default method is feature_adapt's (source_only with
--dataset gtav); val_adapt runs the output_adapt checkpoints.

    python -m s2r_tpu_torch.cli.val --dataset synthetic \\
        --resume <run>/synthetic/deeplab-mobilenet/model_best.ckpt \\
        --out-dir run_val

Runs on the card; ``S2R_PLATFORM=cpu`` selects the CPU.
"""

from __future__ import annotations

import argparse
import os

from s2r_tpu_torch.cli._eval_common import (build_eval, validation,
                                            validation_sep)
from s2r_tpu_torch.config import add_common_flags, config_from_args
from s2r_tpu_torch.core.device import device_from_env


def main(argv=None, method: str = "feature_adapt"):
    parser = argparse.ArgumentParser(description="s2r_tpu_torch validation "
                                     "sweep")
    add_common_flags(parser)
    parser.add_argument("--out-dir", type=str, default="run_val",
                        dest="out_dir")
    parser.add_argument("--skip-sep", action="store_true", dest="skip_sep",
                        help="skip per-image prediction export")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.dataset == "gtav":
        method = "source_only"
    _, model, eval_step, val_loader, _, nclass = build_eval(
        cfg, method, device_from_env())
    if not args.skip_sep:
        validation_sep(cfg, model, eval_step, val_loader, nclass,
                       os.path.join(args.out_dir, "predictions"))
    return validation(cfg, model, eval_step, val_loader, nclass,
                      os.path.join(args.out_dir, "val_info.txt"))


if __name__ == "__main__":
    main()
