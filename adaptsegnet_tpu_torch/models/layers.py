"""Building blocks: frozen-BN folded convs, maxpool, the discriminator's
init law and leaky ReLU.

Counterpart of adaptsegnet_tpu/models/layers.py with frozen BN
(`bn_mode='frozen'`; train-mode BN, `--bn-mode batch`, is not ported yet).
Activations are NCHW views in `channels_last` memory, i.e. NHWC bytes as in
the JAX package; parameters are stored f32 and cast to the compute dtype at
use. Gradients reach `conv.weight` through the BN fold; the scale and the
folded bias carry none (the BN parameters are frozen, as JAX's
stop_gradient at :404-414 makes them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adaptsegnet_tpu_torch.ops.conv3x3 import conv3x3_s1

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


def init_torch_default_(module: nn.Module, generator: torch.Generator) -> None:
    """torch nn.Conv2d's default init, which the reference leaves on the
    discriminator: weight ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (kaiming
    uniform with a = sqrt(5)), bias ~ U with the same bound, fan_in =
    kh * kw * Cin (adaptsegnet_tpu/models/layers.py:32-54)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                cout, cin, kh, kw = m.weight.shape
                bound = 1.0 / math.sqrt(kh * kw * cin)
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                    -bound, bound, generator=generator))
                if m.bias is not None:
                    m.bias.copy_(torch.empty(cout).uniform_(
                        -bound, bound, generator=generator))


def conv_bn_folded(x: torch.Tensor, conv: Conv2d, bn: FrozenBatchNorm2d,
                   dtype: torch.dtype) -> torch.Tensor:
    """conv(x) -> frozen BN, as conv(x, W * s) + (b - mean * s).

    s = scale / sqrt(var + eps). The fold runs in f32 and is cast to the
    compute dtype afterwards, and the folded bias is added in the compute
    dtype (adaptsegnet_tpu/models/layers.py:410-414, :458): folding in
    bf16 would drift from the JAX package. While autograd records, stride-1
    3x3 convs go through ops/conv3x3.py (kernel 2 forward and dgrad where
    it applies); otherwise every conv is a cuDNN conv.
    """
    s = (bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)).detach()
    # channels_last weights: cuDNN would otherwise copy them to the
    # activations' layout on every call.
    w = (conv.weight.float() * s.view(-1, 1, 1, 1)).to(
        dtype, memory_format=torch.channels_last)
    b = (bn.bias.float() - bn.running_mean.float() * s).to(dtype).detach()
    x = x.to(dtype)
    if (w.shape[-1] == 3 and conv.stride == 1
            and conv.padding == conv.dilation and torch.is_grad_enabled()
            and (w.requires_grad or x.requires_grad)):
        y = conv3x3_s1(x, w, conv.dilation)
    else:
        y = F.conv2d(x, w, None, conv.stride, conv.padding, conv.dilation)
    return y + b.view(1, -1, 1, 1)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, 2, padding=1): -inf padding, floor output size, as
    DeeplabMulti pools (model/deeplab_multi.py:135). torch's backward routes
    each window's gradient to its first maximum in row-major scan order,
    the tie rule of the JAX custom VJP (adaptsegnet_tpu/models/layers.py:
    488-560; held by tests/test_torch_train_layers.py)."""
    return F.max_pool2d(x, 3, 2, 1)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """where(x >= 0, x, slope * x): the JAX form (layers.py:621), whose
    gradient at exactly 0 is 1 (torch's F.leaky_relu gives the slope)."""
    return torch.where(x >= 0, x, x * negative_slope)
