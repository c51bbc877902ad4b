"""Building blocks: BN-folded convs (frozen BN, or train-mode BN with frozen
affine), the maxpools, the discriminator's init law and leaky ReLU, and the
Warper's convs, init law and live BN.

Counterpart of adaptsegnet_tpu/models/layers.py: the segmenter's conv + BN
in both `bn_mode`s ('frozen', the default, folds the running statistics
into the weights; 'batch', `--bn-mode batch`, is the reference's train-mode
BN, `_BNTrainFrozenAffine` :299-357), the 3x3/s2 pool in floor and ceil
mode and VGG's 2x2 pool, and the Warper's parts: `xavier_normal_init` (:56), the
4x4/s2/p1 routing of `Conv2d` (:96-137, here `conv2d`), `ConvTranspose2d`
(:157, with ops/conv_transpose4x4.py's function) and the live BatchNorm of
adaptsegnet_tpu/models/warper.py::_WarperBN (:87-100).
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
from adaptsegnet_tpu_torch.parallel import group
from adaptsegnet_tpu_torch.ops.conv4x4 import conv4x4_stride2
from adaptsegnet_tpu_torch.ops.precision import tf32_for

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


BN_MOMENTUM = 0.1  # torch's convention: ra = (1 - m) * ra + m * batch


def bn_train_frozen_affine(y: torch.Tensor, bn: FrozenBatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm with frozen affine on an NCHW conv output: the
    reference's backbone BN under model.train() (JAX
    `_BNTrainFrozenAffine`, models/layers.py:299-357).

    Normalises by the batch statistics in f32 (mean, then the two-pass
    biased variance E[(y - mean)^2]; E[y^2] - mean^2 cancels in f32 and the
    error compounds over the backbone's ~100 BNs) and updates `bn`'s running
    statistics in place with torch's momentum 0.1, the variance unbiased
    (n / (n - 1)). Gradients flow through the batch statistics; the affine
    and the running updates carry none. Rounded once to y's dtype.

    In a data-parallel group of more than one rank the statistics are the
    global batch's, as GSPMD makes them in the JAX package: both passes sum
    over the group through a differentiable all-reduce (its backward sums
    the statistics' gradients over the ranks), and n is the global count."""
    yf = y.float()
    shape = (1, -1, 1, 1)
    n = y.shape[0] * y.shape[2] * y.shape[3]
    if group.world() > 1:
        n *= group.world()
        mean = group.all_reduce_sum_grad(yf.sum(dim=(0, 2, 3))) / n
        centred = yf - mean.view(shape)
        var = group.all_reduce_sum_grad(centred.square().sum(dim=(0, 2, 3))) / n
    else:
        mean = yf.mean(dim=(0, 2, 3))
        centred = yf - mean.view(shape)
        var = centred.square().mean(dim=(0, 2, 3))
    with torch.no_grad():
        m = BN_MOMENTUM
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var
                             + m * var * (n / max(n - 1, 1)))
    out = centred * torch.rsqrt(var + BN_EPS).view(shape)
    out = (out * bn.weight.detach().float().view(shape)
           + bn.bias.detach().float().view(shape))
    return out.to(y.dtype)


def conv_bn_folded(x: torch.Tensor, conv: Conv2d, bn: FrozenBatchNorm2d,
                   dtype: torch.dtype, bn_mode: str = "frozen") -> torch.Tensor:
    """conv(x) -> frozen BN, as conv(x, W * s) + (b - mean * s).

    s = scale / sqrt(var + eps). The fold runs in f32 and is cast to the
    compute dtype afterwards, and the folded bias is added in the compute
    dtype (adaptsegnet_tpu/models/layers.py:410-414, :458): folding in
    bf16 would drift from the JAX package. Stride-1 3x3 convs with
    padding == dilation go through ops/conv3x3.py (kernel 2 forward and
    dgrad while autograd records, kernel 3 for a batched bf16 forward
    without autograd, where they apply); every other conv is a cuDNN conv.

    `bn_mode='batch'` folds nothing (the normalisation depends on the conv
    output's batch statistics): the raw conv through the same routing, then
    `bn_train_frozen_affine` (JAX :395-400, :456-457). The state-dict keys
    are the same in both modes.
    """
    if bn_mode not in ("frozen", "batch"):
        raise ValueError(f"bn_mode must be 'frozen' or 'batch': {bn_mode!r}")
    if bn_mode == "batch":
        w = conv.weight.to(dtype, memory_format=torch.channels_last)
        return bn_train_frozen_affine(_conv(x.to(dtype), w, conv), bn)
    s = (bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)).detach()
    # channels_last weights: cuDNN would otherwise copy them to the
    # activations' layout on every call.
    w = (conv.weight.float() * s.view(-1, 1, 1, 1)).to(
        dtype, memory_format=torch.channels_last)
    b = (bn.bias.float() - bn.running_mean.float() * s).to(dtype).detach()
    return _conv(x.to(dtype), w, conv) + b.view(1, -1, 1, 1)


def _conv(x: torch.Tensor, w: torch.Tensor, conv: Conv2d) -> torch.Tensor:
    """The bias-free conv of `conv`'s geometry with the weights `w`."""
    if (w.shape[-1] == 3 and conv.stride == 1
            and conv.padding == conv.dilation):
        return conv3x3_s1(x, w, conv.dilation)
    return F.conv2d(x, w, None, conv.stride, conv.padding, conv.dilation)


def max_pool_3x3_s2(x: torch.Tensor, ceil_mode: bool = False) -> torch.Tensor:
    """torch MaxPool2d(3, 2, padding=1, ceil_mode): -inf padding; floor
    output size as DeeplabMulti pools (model/deeplab_multi.py:135), ceil as
    the single-head 'Oracle' ResNet does (model/deeplab.py:130). torch's
    backward routes each window's gradient to its first maximum in
    row-major scan order, the tie rule of the JAX custom VJP
    (adaptsegnet_tpu/models/layers.py:461-560)."""
    return F.max_pool2d(x, 3, 2, 1, ceil_mode=ceil_mode)


def max_pool_2x2_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(2, 2), VGG-16's pools (an odd trailing row or column
    is dropped); the same tie rule (JAX :563-620)."""
    return F.max_pool2d(x, 2, 2)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """where(x >= 0, x, slope * x): the JAX form (layers.py:621), whose
    gradient at exactly 0 is 1 (torch's F.leaky_relu gives the slope)."""
    return torch.where(x >= 0, x, x * negative_slope)


# ------------------------------------------------------------- the Warper's


class ConvTranspose2d(nn.Module):
    """Parameter holder with torch ConvTranspose2d(k=4, s=2, p=1)'s keys:
    `weight` (Cin, Cout, 4, 4), optional `bias`. Allocated uninitialised."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


def xavier_normal_(module: nn.Module, generator: torch.Generator,
                   gain: float = 0.02) -> None:
    """torch init.xavier_normal_(gain) on every Conv2d / ConvTranspose2d of
    `module`, biases 0: N(0, gain^2 * 2 / (fan_in + fan_out)) with fan_in =
    k*k*Cin and fan_out = k*k*Cout (JAX `xavier_normal_init`, the
    reference Warper's 'xavier' init, model/warper.py:147-178)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                shape = m.weight.shape
                cout, cin = ((shape[1], shape[0]) if isinstance(m, ConvTranspose2d)
                             else (shape[0], shape[1]))
                k2 = shape[2] * shape[3]
                std = gain * math.sqrt(2.0 / (k2 * cin + k2 * cout))
                m.weight.copy_(torch.empty(shape).normal_(
                    0.0, std, generator=generator))
                if m.bias is not None:
                    m.bias.zero_()


def conv2d(x: torch.Tensor, conv: Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """conv(x) in the compute dtype on an NCHW view in channels_last memory.

    A 4x4 / stride-2 / pad-1 conv on an even-sized input goes through
    ops/conv4x4.py::conv4x4_stride2 (kernel 5 where it applies: bf16, 2*Cin
    and Cout multiples of 128), as JAX's Conv2d routes it to its matmul
    lowering; any other conv is a cuDNN conv."""
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    x = x.to(dtype)
    if (w.shape[-1] == 4 and conv.stride == 2 and conv.padding == 1
            and conv.dilation == 1 and x.shape[2] % 2 == 0
            and x.shape[3] % 2 == 0):
        return conv4x4_stride2(x.permute(0, 2, 3, 1), w, b).permute(0, 3, 1, 2)
    return F.conv2d(x, w.contiguous(memory_format=torch.channels_last), b,
                    conv.stride, conv.padding, conv.dilation)


def conv_transpose4x4_stride2(x: torch.Tensor, conv: ConvTranspose2d,
                              dtype: torch.dtype,
                              weight: torch.Tensor | None = None) -> torch.Tensor:
    """torch ConvTranspose2d(Cin, Cout, 4, stride 2, padding 1) in the
    compute dtype (adaptsegnet_tpu/ops/conv_transpose4x4.py, custom XLA
    lowering there, a library call here): the products of the dtype's
    values summed in f32 with the bias, rounded once to the dtype, as the
    JAX lowering's f32 accumulation does."""
    w = (conv.weight if weight is None else weight).to(dtype).float()
    b = None if conv.bias is None else conv.bias.to(dtype).float()
    with tf32_for(dtype):
        y = F.conv_transpose2d(x.to(dtype).float(), w, b, 2, 1)
    return y.to(dtype).contiguous(memory_format=torch.channels_last)


class WarperBatchNorm2d(nn.Module):
    """The Warper's live BatchNorm: flax nn.BatchNorm(momentum=0.9, eps 1e-5)
    as adaptsegnet_tpu/models/warper.py::_WarperBN builds it, with torch
    BatchNorm2d's state-dict keys.

    In train mode (`self.training`) it normalises by the batch statistics,
    computed in f32 as flax does (mean and E[x^2] - mean^2, the biased
    variance, clipped at 0), and updates the running statistics in place
    with flax's convention ra = 0.9 * ra + 0.1 * batch, the variance
    biased (torch's nn.BatchNorm2d would store the unbiased one). In eval
    mode it uses the running statistics. The affine (weight ~ N(1, 0.02),
    bias 0) applies in f32; the output is rounded once to x's dtype.

    In a data-parallel group of more than one rank the train-mode
    statistics are the global batch's: the sums of x and x^2 are
    all-reduced together (the Warper runs under no_grad, so no gradient
    flows through them).
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = (1, -1, 1, 1)
        if self.training:
            if group.world() > 1:
                n = x.shape[0] * x.shape[2] * x.shape[3] * group.world()
                sums = group.all_reduce_sum(torch.stack(
                    [xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
                mean, sq = sums[0] / n, sums[1] / n
            else:
                mean = xf.mean(dim=(0, 2, 3))
                sq = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)
