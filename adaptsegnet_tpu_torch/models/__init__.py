"""Models of the port: the multi-level DeepLab-v2 segmenter and the
fully-convolutional discriminator."""

from adaptsegnet_tpu_torch.models.deeplab_resnet import (
    Bottleneck,
    ClassifierModule,
    DeeplabMulti,
    ResNetBackbone,
)
from adaptsegnet_tpu_torch.models.discriminator import FCDiscriminator

__all__ = ["Bottleneck", "ClassifierModule", "DeeplabMulti", "FCDiscriminator",
           "ResNetBackbone"]
