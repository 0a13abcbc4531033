"""Validation sweep of an output-space adaptation checkpoint (reference
val_adapt.py): per-image PNGs unless --skip-sep, then the report.

    python -m s2r_tpu_torch.cli.val_adapt --dataset synthetic \\
        --resume <run>/synthetic/deeplab-mobilenet/model_best.ckpt
"""

from __future__ import annotations

from s2r_tpu_torch.cli.val import main as _main


def main(argv=None):
    return _main(argv, method="output_adapt")


if __name__ == "__main__":
    main()
