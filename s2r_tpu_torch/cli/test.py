"""Label-free inference sweep of a feature_adapt or source_only checkpoint
(s2r_tpu/cli/test.py, reference test.py): each test image's prediction
saved as a labelId PNG and a color PNG at 1280x640.

    python -m s2r_tpu_torch.cli.test --dataset synthetic \\
        --resume <run>/synthetic/deeplab-mobilenet/model_best.ckpt \\
        --out-dir result

Runs on the card; ``S2R_PLATFORM=cpu`` selects the CPU.
"""

from __future__ import annotations

import argparse

from s2r_tpu_torch.cli import _eval_common
from s2r_tpu_torch.config import add_common_flags, config_from_args
from s2r_tpu_torch.core.device import device_from_env


def main(argv=None, method: str = "feature_adapt"):
    parser = argparse.ArgumentParser(description="s2r_tpu_torch test sweep")
    add_common_flags(parser)
    parser.add_argument("--out-dir", type=str, default="result",
                        dest="out_dir")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.dataset == "gtav":
        method = "source_only"
    _, model, eval_step, _, test_loader, _ = _eval_common.build_eval(
        cfg, method, device_from_env())
    _eval_common.test_sweep(cfg, model, eval_step, test_loader, args.out_dir)


if __name__ == "__main__":
    main()
