"""DeepLab-V3+ and its backbones (MobileNetV2, ResNet, Aligned Xception,
DRN-D-54), the discriminators, and their layers."""
