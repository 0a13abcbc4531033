"""Validation sweep of a checkpoint: the aggregate per-class IoU report
(s2r_tpu/cli/val.py, reference val.py).  Requires --resume and, until the
per-image PNG export is ported (ROADMAP A.4/A.5), --skip-sep.

Runs on the card; ``S2R_PLATFORM=cpu`` selects the CPU.
"""

from __future__ import annotations

import argparse
import os

from s2r_tpu_torch.cli._eval_common import (build_eval, validation,
                                            validation_sep)
from s2r_tpu_torch.config import (add_common_flags, check_ported,
                                  config_from_args)
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
    # the split-model methods (this default among them) are not ported:
    # raise before anything is built
    check_ported(cfg, method)
    if not args.skip_sep:
        validation_sep()
    device = device_from_env()
    _, model, eval_step, val_loader, _, nclass = build_eval(cfg, method,
                                                            device)
    return validation(cfg, model, eval_step, val_loader, nclass,
                      os.path.join(args.out_dir, "val_info.txt"))


if __name__ == "__main__":
    main()
