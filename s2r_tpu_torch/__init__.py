"""s2r_tpu_torch — the PyTorch/CUDA port of s2r_tpu for NVIDIA Hopper.

Trains and serves DeepLab-V3+ on MobileNetV2, ResNet-101/50, Aligned
Xception-65 and DRN-D-54 (output stride 16 or 8), exact and decoder-int8.
The stride-1 depthwise 3x3 convs (forward and backward), train-mode
BatchNorm, the discriminator's first conv and the int8 requantization
run on hand-written CUDA kernels (``csrc/``), built with plain nvcc at
first use (``ops/kernels/build.py``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

Importing the package loads nothing heavy; import the submodules.
"""
