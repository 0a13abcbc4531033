"""DeepLab-V3+ on MobileNetV2, eval forward."""
