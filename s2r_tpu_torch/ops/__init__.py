"""Tensor ops: align-corners resize, channel argmax, hand-written kernels."""
