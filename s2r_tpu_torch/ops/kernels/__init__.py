"""Hand-written CUDA kernels (sources in s2r_tpu_torch/csrc), one wrapper
module each, with the plain PyTorch version of the same function beside it."""
