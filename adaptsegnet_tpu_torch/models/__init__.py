"""Models of the port: the multi-level DeepLab-v2 segmenter, the
fully-convolutional discriminator and the flow-field Warper."""

from adaptsegnet_tpu_torch.models.deeplab_resnet import (
    Bottleneck,
    ClassifierModule,
    DeeplabMulti,
    ResNetBackbone,
)
from adaptsegnet_tpu_torch.models.discriminator import FCDiscriminator
from adaptsegnet_tpu_torch.models.warper import Warper

__all__ = ["Bottleneck", "ClassifierModule", "DeeplabMulti", "FCDiscriminator",
           "ResNetBackbone", "Warper"]
