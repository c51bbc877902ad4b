"""VGG-16 DeepLab-v2 segmenter.

Counterpart of adaptsegnet_tpu/models/deeplab_vgg.py (`DeeplabVGG` :47;
reference model/deeplab_vgg.py:24-54): torchvision VGG-16 `features` with
pool4 and pool5 removed, the three conv5 convs dilated by 2, then dilated
fc6 / fc7 (1024 channels, 3x3, dilation 4) with ReLU, and an ASPP
`classifier` head on the 1024 channels. Three 2x2 pools remain, so the
output stride is 8. Every conv has a bias and there is no BN.

The JAX package runs these convs as plain library convs (its `Conv2d`, not
`conv3x3_s1`), so they are cuDNN convs here and the hand-written 3x3 kernels
are not taken. Module names give the reference's state-dict keys:
`features.<i>.weight` with i the conv's index in the pruned Sequential, and
`classifier.conv2d_list.<b>.*`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adaptsegnet_tpu_torch.device import resolve_device
from adaptsegnet_tpu_torch.models.deeplab_resnet import (
    ClassifierModule,
    _generator,
    _to_nchw_view,
)
from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    conv2d,
    init_normal_,
    max_pool_2x2_s2,
)
from adaptsegnet_tpu_torch.ops import precision

# (index in the reference's `features` Sequential, out channels, dilation)
# per conv; None marks a 2x2 maxpool. ReLUs sit at the indices between.
VGG_PLAN = (
    (0, 64, 1), (2, 64, 1), None,
    (5, 128, 1), (7, 128, 1), None,
    (10, 256, 1), (12, 256, 1), (14, 256, 1), None,
    (17, 512, 1), (19, 512, 1), (21, 512, 1),      # pool4 removed
    (23, 512, 2), (25, 512, 2), (27, 512, 2),      # pool5 removed
    (29, 1024, 4), (31, 1024, 4),                  # fc6, fc7
)


class DeeplabVGG(nn.Module):
    """(N, H, W, 3) NHWC -> raw stride-8 logits (N, h, w, classes) NHWC.

    `aspp_sum` defaults to 'first2' for the released GTA2Cityscapes_vgg
    checkpoint; `device` and `generator` as for ResNetBackbone (every conv
    weight ~ N(0, 0.01), biases 0).
    """

    def __init__(self, num_classes: int = 19, aspp_sum: str = "first2",
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        device = resolve_device(device)
        super().__init__()
        self.dtype = dtype
        cin, convs = 3, {}
        for item in VGG_PLAN:
            if item is not None:
                idx, cout, dil = item
                convs[str(idx)] = Conv2d(cin, cout, 3, padding=dil,
                                         dilation=dil, bias=True)
                cin = cout
        self.features = nn.ModuleDict(convs)
        self.classifier = ClassifierModule(cin, num_classes, aspp_sum)
        init_normal_(self, _generator(generator))
        precision.configure(dtype)
        self.to(device)

    def forward(self, x_nhwc: torch.Tensor,
                return_features: bool = False) -> torch.Tensor:
        """`return_features=True` stops after fc7 + ReLU (the reference's
        `self.features` output)."""
        x = _to_nchw_view(x_nhwc)
        for item in VGG_PLAN:
            if item is None:
                x = max_pool_2x2_s2(x)
            else:
                x = F.relu(conv2d(x, self.features[str(item[0])], self.dtype))
        if not return_features:
            x = self.classifier(x, self.dtype)
        return x.permute(0, 2, 3, 1)
