"""Label-free inference sweep of an output-space adaptation checkpoint
(s2r_tpu/cli/test_adapt.py, reference test_adapt.py)."""

from __future__ import annotations

from s2r_tpu_torch.cli.test import main as _main


def main(argv=None):
    return _main(argv, method="output_adapt")


if __name__ == "__main__":
    main()
