"""Dilated ResNet-101 DeepLab-v2: multi-level (two ASPP heads) and the
single-head 'Oracle'.

Counterpart of adaptsegnet_tpu/models/deeplab_resnet.py (`Bottleneck` :44,
`ClassifierModule` :107, `ResNetBackbone` :162, `DeeplabMulti` :206,
`DeeplabSingle` :233):
  * Bottleneck: stride on the 1x1 reduce conv, dilation on the 3x3
    (model/deeplab_multi.py:59-103); every conv+BN pair is BN-folded.
  * conv1 7x7/2 -> BN -> ReLU -> maxpool 3x3/2 (floor) -> layer1(3) ->
    layer2(4, /2) -> layer3(23, d2) -> layer4(3, d4); a projection shortcut
    on block 0 of every layer. Output stride 8.
  * ASPP heads: layer5 on layer3's 1024 channels, layer6 on layer4's 2048
    (DeeplabMulti); layer5 on layer4 after a ceil-mode pool (DeeplabSingle).
  * `bn_mode`: 'frozen' (default) or 'batch', the reference's train-mode BN
    with frozen affine (models/layers.py); same state-dict keys.

Public tensors are NHWC, as in the JAX package: the model takes (N, H, W, 3)
and returns raw stride-8 `(pred1, pred2)` logits (N, h, w, classes). Inside,
`x.permute(0, 3, 1, 2)` is an NCHW view of the same bytes in `channels_last`
memory, which cuDNN runs as NHWC with no copy. Module attribute names give
the reference's state-dict keys (utils/pth_interop.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adaptsegnet_tpu_torch.device import resolve_device
from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    FrozenBatchNorm2d,
    conv_bn_folded,
    init_normal_,
    max_pool_3x3_s2,
)
from adaptsegnet_tpu_torch.ops import precision
from adaptsegnet_tpu_torch.ops.aspp import aspp_sum

_LAYER_SPECS = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
_ASPP_DILATIONS = (6, 12, 18, 24)


class Bottleneck(nn.Module):
    """1x1(stride) / 3x3(dilated) / 1x1(x4) residual block, frozen BN."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, stride=stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                            dilation=dilation)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(cin, planes * 4, 1, stride=stride),
            FrozenBatchNorm2d(planes * 4),
        ) if has_downsample else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                bn_mode: str = "frozen") -> torch.Tensor:
        out = F.relu(conv_bn_folded(x, self.conv1, self.bn1, dtype, bn_mode))
        out = F.relu(conv_bn_folded(out, self.conv2, self.bn2, dtype, bn_mode))
        out = conv_bn_folded(out, self.conv3, self.bn3, dtype, bn_mode)
        residual = x
        if self.downsample is not None:
            residual = conv_bn_folded(x, self.downsample[0],
                                      self.downsample[1], dtype, bn_mode)
        return F.relu(out + residual)


class ClassifierModule(nn.Module):
    """ASPP head: the sum of dilated 3x3 convs (d = 6, 12, 18, 24) down to
    `num_classes` maps. `aspp_sum='all'` sums all four, as DeeplabMulti
    does; 'first2' sums branches 0 and 1 only, the reference's early-return
    quirk of the single-head and VGG variants (model/deeplab.py,
    model/deeplab_vgg.py:19-21), kept for their released checkpoints. All
    four branches hold parameters either way."""

    def __init__(self, cin: int, num_classes: int, aspp_sum: str = "all"):
        super().__init__()
        if aspp_sum not in ("all", "first2"):
            raise ValueError(f"aspp_sum must be 'all' or 'first2': {aspp_sum!r}")
        self.n_sum = len(_ASPP_DILATIONS) if aspp_sum == "all" else 2
        self.conv2d_list = nn.ModuleList(
            Conv2d(cin, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in _ASPP_DILATIONS
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return aspp_sum(
            x.to(dtype),
            [c.weight for c in self.conv2d_list],
            [c.bias for c in self.conv2d_list],
            _ASPP_DILATIONS,
            self.n_sum,
        )


class ResNetBackbone(nn.Module):
    """conv1..layer4 of the dilated ResNet (output stride 8).

    `features` takes an NCHW view in channels_last memory and returns
    `{'layer1': ..., 'layer4': ...}` in the same form; `forward` is its NHWC
    face. `layers` sets the block count of each stage ((3, 4, 23, 3) is
    ResNet-101; tests cut it); `ceil_mode_pool` and `bn_mode` as in the
    module note. Weights are drawn with the reference's init
    law from `generator` (default: a generator seeded with 0) and the module
    is placed on `device` (default: the CUDA card; raises if there is none).
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 ceil_mode_pool: bool = False, bn_mode: str = "frozen"):
        device = resolve_device(device)
        super().__init__()
        self.dtype = dtype
        self.ceil_mode_pool, self.bn_mode = ceil_mode_pool, bn_mode
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for li, ((planes, stride, dilation), blocks) in enumerate(
            zip(_LAYER_SPECS, layers), start=1
        ):
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(
                    cin, planes, stride=stride if bi == 0 else 1,
                    dilation=dilation, has_downsample=(bi == 0),
                ))
                cin = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*stage))
        init_normal_(self, _generator(generator))
        precision.configure(dtype)
        self.to(device)

    def features(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu(conv_bn_folded(x, self.conv1, self.bn1, self.dtype,
                                  self.bn_mode))
        x = max_pool_3x3_s2(x, self.ceil_mode_pool)
        feats = {}
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x, self.dtype, self.bn_mode)
            feats[f"layer{li}"] = x
        return feats

    def forward(self, x_nhwc: torch.Tensor) -> dict[str, torch.Tensor]:
        """(N, H, W, 3) -> {layer name: (N, h, w, C)} NHWC features."""
        feats = self.features(_to_nchw_view(x_nhwc))
        return {k: v.permute(0, 2, 3, 1) for k, v in feats.items()}


class DeeplabMulti(ResNetBackbone):
    """Multi-level DeepLab-v2: ASPP heads on layer3 (aux) and layer4 (main).

    Returns `(pred1, pred2)` raw stride-8 logits, NHWC; pred2 is the main
    output. `device` and `generator` as for ResNetBackbone; the heads draw
    from the same generator after the backbone.
    """

    def __init__(self, num_classes: int = 19,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 bn_mode: str = "frozen"):
        device = resolve_device(device)
        generator = _generator(generator)
        super().__init__(dtype=dtype, device="cpu",
                         generator=generator, bn_mode=bn_mode)
        self.layer5 = ClassifierModule(1024, num_classes)
        self.layer6 = ClassifierModule(2048, num_classes)
        init_normal_(self.layer5, generator)
        init_normal_(self.layer6, generator)
        self.to(device)

    def forward(self, x_nhwc: torch.Tensor):
        feats = self.features(_to_nchw_view(x_nhwc))
        pred1 = self.layer5(feats["layer3"], self.dtype)
        pred2 = self.layer6(feats["layer4"], self.dtype)
        return pred1.permute(0, 2, 3, 1), pred2.permute(0, 2, 3, 1)


class DeeplabSingle(ResNetBackbone):
    """Single-head 'Oracle' ResNet DeepLab (reference model/deeplab.py): one
    ASPP head `layer5` on layer4, behind a ceil-mode pool, so at 512x1024
    the logit map is 65x129, one pixel larger than DeeplabMulti's.

    Returns the raw stride-8 logits, NHWC. `aspp_sum` defaults to 'first2'
    for the released cityscapes_oracle checkpoint (trained with the
    reference's early-return ASPP); 'all' is the intended head.
    """

    def __init__(self, num_classes: int = 19, aspp_sum: str = "first2",
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 bn_mode: str = "frozen"):
        device = resolve_device(device)
        generator = _generator(generator)
        super().__init__(dtype=dtype, device="cpu", generator=generator,
                         ceil_mode_pool=True, bn_mode=bn_mode)
        self.layer5 = ClassifierModule(2048, num_classes, aspp_sum)
        init_normal_(self.layer5, generator)
        self.to(device)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        feats = self.features(_to_nchw_view(x_nhwc))
        return self.layer5(feats["layer4"], self.dtype).permute(0, 2, 3, 1)


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def _to_nchw_view(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) contiguous -> NCHW view in channels_last memory."""
    return x_nhwc.contiguous().permute(0, 3, 1, 2)
