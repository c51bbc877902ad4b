"""Fully-convolutional output-space discriminator.

Counterpart of adaptsegnet_tpu/models/discriminator.py::FCDiscriminator
(`:57-121`; reference model/discriminator.py:5-34): five 4x4/stride-2/pad-1
convs, C -> 64 -> 128 -> 256 -> 512 -> 1, LeakyReLU(0.2) between, no final
sigmoid. State-dict keys are the reference's (`conv1` .. `conv4`,
`classifier`, each `.weight` OIHW and `.bias`); parameters are stored f32
and cast to the compute dtype at use; the init is torch's Conv2d default.

The input is the planar (N, C, H, W) softmax map from
ops/resize.py::upsample_softmax_planar. conv1 runs kernel 4 in bf16
(ops/conv4x4.py::conv4x4_patch), conv2..conv4 kernel 5
(`conv4x4_stride2`); the classifier (512 -> 1) and the f32 path are library
convs. Activations between the convs are NHWC. Returns the (N, H/32, W/32, 1)
NHWC score map.
"""

from __future__ import annotations

import torch
from torch import nn

from adaptsegnet_tpu_torch.device import resolve_device
from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    init_torch_default_,
    leaky_relu,
)
from adaptsegnet_tpu_torch.ops.conv4x4 import conv4x4_patch, conv4x4_stride2


class FCDiscriminator(nn.Module):
    def __init__(self, num_classes: int = 19, ndf: int = 64,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        device = resolve_device(device)
        super().__init__()
        self.dtype = dtype
        widths = [num_classes, ndf, ndf * 2, ndf * 4, ndf * 8, 1]
        names = ["conv1", "conv2", "conv3", "conv4", "classifier"]
        for name, cin, cout in zip(names, widths[:-1], widths[1:]):
            setattr(self, name, Conv2d(cin, cout, 4, stride=2, padding=1,
                                       bias=True))
        init_torch_default_(
            self, torch.Generator().manual_seed(0) if generator is None
            else generator)
        self.to(device)

    def _wb(self, conv: Conv2d):
        return conv.weight.to(self.dtype), conv.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) planar map -> (N, H/32, W/32, 1) raw scores."""
        h = leaky_relu(conv4x4_patch(x.to(self.dtype), *self._wb(self.conv1)))
        for conv in (self.conv2, self.conv3, self.conv4):
            h = leaky_relu(conv4x4_stride2(h, *self._wb(conv)))
        return conv4x4_stride2(h, *self._wb(self.classifier))
