"""Building blocks of the DeepLab backbone: frozen-BN folded convs, maxpool.

Counterpart of adaptsegnet_tpu/models/layers.py in its frozen (eval) mode.
Activations are NCHW views in `channels_last` memory, i.e. NHWC bytes as in
the JAX package; parameters are stored f32 and cast to the compute dtype at
use. Train-mode BN (`bn_mode='batch'`) belongs to the train slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class Conv2d(nn.Module):
    """Parameter holder with torch Conv2d's keys (`weight`, `bias`) and
    geometry; the forward lives in the caller (folded or summed in f32).

    Parameters are allocated uninitialised: `init_normal_` fills them.
    """

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm with torch BatchNorm2d's state-dict keys.

    The reference freezes the backbone BN (model/deeplab_multi.py:66-78);
    its statistics come from the checkpoint. Initial values are the JAX
    package's: scale 1, bias 0, mean 0, var 1.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))


def init_normal_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.01) -> None:
    """The reference's DeepLab init: every conv weight ~ N(0, std), biases 0
    (model/deeplab_multi.py:144-150; JAX `normal_conv_init`)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                w = torch.empty(m.weight.shape).normal_(
                    0.0, std, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()


def conv_bn_folded(x: torch.Tensor, conv: Conv2d, bn: FrozenBatchNorm2d,
                   dtype: torch.dtype) -> torch.Tensor:
    """conv(x) -> frozen BN, as conv(x, W * s) + (b - mean * s).

    s = scale / sqrt(var + eps). The fold runs in f32 and is cast to the
    compute dtype afterwards, and the folded bias is added in the compute
    dtype (adaptsegnet_tpu/models/layers.py:410-414, :458): folding in
    bf16 would drift from the JAX package.
    """
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    # channels_last weights: cuDNN would otherwise copy them to the
    # activations' layout on every call.
    w = (conv.weight.float() * s.view(-1, 1, 1, 1)).to(
        dtype, memory_format=torch.channels_last)
    b = (bn.bias.float() - bn.running_mean.float() * s).to(dtype)
    y = F.conv2d(x.to(dtype), w, None, conv.stride, conv.padding,
                 conv.dilation)
    return y + b.view(1, -1, 1, 1)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, 2, padding=1): -inf padding, floor output size, as
    DeeplabMulti pools (model/deeplab_multi.py:135)."""
    return F.max_pool2d(x, 3, 2, 1)
