"""Models of the port: the DeepLab-v2 segmenters (multi-level and single-head
ResNet-101, VGG-16), the fully-convolutional discriminator and the
flow-field Warper."""

from adaptsegnet_tpu_torch.models.deeplab_resnet import (
    Bottleneck,
    ClassifierModule,
    DeeplabMulti,
    DeeplabSingle,
    ResNetBackbone,
)
from adaptsegnet_tpu_torch.models.deeplab_vgg import DeeplabVGG
from adaptsegnet_tpu_torch.models.discriminator import FCDiscriminator
from adaptsegnet_tpu_torch.models.warper import Warper

__all__ = ["Bottleneck", "ClassifierModule", "DeeplabMulti", "DeeplabSingle",
           "DeeplabVGG", "FCDiscriminator", "ResNetBackbone", "Warper"]
