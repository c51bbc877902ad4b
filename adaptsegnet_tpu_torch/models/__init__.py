"""Models of the port: the multi-level DeepLab-v2 segmenter."""

from adaptsegnet_tpu_torch.models.deeplab_resnet import (
    Bottleneck,
    ClassifierModule,
    DeeplabMulti,
    ResNetBackbone,
)

__all__ = ["Bottleneck", "ClassifierModule", "DeeplabMulti", "ResNetBackbone"]
