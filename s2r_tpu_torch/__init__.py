"""s2r_tpu_torch — the PyTorch/CUDA port of s2r_tpu for NVIDIA Hopper.

Serves DeepLab-V3+ on MobileNetV2 (output stride 16) in exact and
decoder-int8 modes.  The stride-1 depthwise 3x3 convs and the int8
requantization run on hand-written CUDA kernels (``csrc/``), built with
plain nvcc at first use (``ops/kernels/build.py``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

Importing the package loads nothing heavy; import the submodules.
"""
