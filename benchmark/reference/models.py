"""Plain float32 models of AdaptSegNet, written from the papers.

* `DeeplabMulti`: DeepLab-v2 (Chen et al., arXiv:1606.00915) on a dilated
  ResNet-101 at output stride 8, with AdaptSegNet's two ASPP heads
  (Tsai et al., arXiv:1802.10349, section 4): the auxiliary head on
  layer3, the main head on layer4, each the sum of four 3x3 convolutions
  at dilations 6, 12, 18 and 24. Bottleneck: 1x1 (carrying the stride),
  3x3 (carrying the dilation), 1x1 (x4), a projection shortcut on each
  stage's first block; the BatchNorm layers are frozen (inference mode).
* `FCDiscriminator`: five 4x4 stride-2 convolutions, 64-128-256-512-1,
  LeakyReLU(0.2) between, no sigmoid, on the softmax map.
* `Warper`: the sahngmin/AdaptSegNet fork's U-Net flow predictor
  (`model/warper.py`): an encoder of 4x4 stride-2 convolutions (LeakyReLU
  0.2, then conv, then BatchNorm, after the first), a decoder of ReLU, x2
  half-pixel bilinear upsample, 3x3 conv and BatchNorm with the encoder's
  skips concatenated in front, and a 3x3 output convolution to a 2-channel
  flow. Its BatchNorm follows the fork's flax port: batch statistics in
  train mode, the biased variance E[x^2] - mean^2 clipped at 0, running
  statistics r <- 0.9 r + 0.1 batch.

Module and parameter names give the reference checkpoints' state-dict
keys, so one state dict loads here and into the program. Parameters are
allocated uninitialised: the benchmark loads its seeded weights into them.
Tensors are NCHW; `DeeplabMulti` takes NHWC images, as the program does.
Each convolution goes through a `Numerics` (numerics.py), which decides
the precision of its operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.numerics import Numerics

BN_EPS = 1e-5


class Conv(nn.Module):
    def __init__(self, num: Numerics, cin: int, cout: int, k: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, device=None):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if bias else None)
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x):
        return self.num.conv2d(x, self.weight, self.bias, self.stride,
                               self.padding, self.dilation)


class FrozenBN(nn.Module):
    """BatchNorm in inference mode; its affine does not train."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c, device=device),
                                 requires_grad=False)
        self.register_buffer("running_mean", torch.empty(c, device=device))
        self.register_buffer("running_var", torch.empty(c, device=device))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


class Bottleneck(nn.Module):
    def __init__(self, num, cin, planes, stride, dilation, down, device):
        super().__init__()
        self.conv1 = Conv(num, cin, planes, 1, stride, device=device)
        self.bn1 = FrozenBN(planes, device)
        self.conv2 = Conv(num, planes, planes, 3, 1, dilation, dilation,
                          device=device)
        self.bn2 = FrozenBN(planes, device)
        self.conv3 = Conv(num, planes, planes * 4, 1, device=device)
        self.bn3 = FrozenBN(planes * 4, device)
        self.downsample = (nn.Sequential(
            Conv(num, cin, planes * 4, 1, stride, device=device),
            FrozenBN(planes * 4, device)) if down else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ASPP(nn.Module):
    def __init__(self, num, cin, classes, dilations, device):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            Conv(num, cin, classes, 3, 1, d, d, bias=True, device=device)
            for d in dilations)

    def forward(self, x):
        return sum(conv(x) for conv in self.conv2d_list)


class DeeplabMulti(nn.Module):
    """(N, H, W, 3) images -> (pred1, pred2) NCHW logits at stride 8."""

    def __init__(self, cfg: dict, num: Numerics, device=None):
        super().__init__()
        self.conv1 = Conv(num, 3, 64, 7, 2, 3, device=device)
        self.bn1 = FrozenBN(64, device)
        cin = 64
        for i, (blocks, planes, stride, dilation) in enumerate(zip(
                cfg["blocks"], cfg["planes"], cfg["strides"],
                cfg["dilations"]), start=1):
            stage = []
            for b in range(blocks):
                stage.append(Bottleneck(num, cin, planes,
                                        stride if b == 0 else 1, dilation,
                                        b == 0, device))
                cin = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*stage))
        c3 = cfg["planes"][2] * 4
        self.layer5 = ASPP(num, c3, cfg["num_classes"], cfg["aspp_dilations"],
                           device)
        self.layer6 = ASPP(num, cin, cfg["num_classes"], cfg["aspp_dilations"],
                           device)

    def features(self, images):
        x = F.relu(self.bn1(self.conv1(images.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer2(self.layer1(x))
        f3 = self.layer3(x)
        return f3, self.layer4(f3)

    def forward(self, images):
        f3, f4 = self.features(images)
        return self.layer5(f3), self.layer6(f4)

    def main_head(self, images):
        """pred2 alone: the evaluation's output."""
        return self.layer6(self.features(images)[1])


class FCDiscriminator(nn.Module):
    def __init__(self, cfg: dict, num: Numerics, device=None):
        super().__init__()
        widths = [cfg["num_classes"], *cfg["d_widths"], 1]
        names = ("conv1", "conv2", "conv3", "conv4", "classifier")
        for name, cin, cout in zip(names, widths[:-1], widths[1:]):
            setattr(self, name, Conv(num, cin, cout, 4, 2, 1, bias=True,
                                     device=device))

    def forward(self, x):
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = F.leaky_relu(conv(x), 0.2)
        return self.classifier(x)


class WarperBN(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.register_buffer("running_mean", torch.empty(c, device=device))
        self.register_buffer("running_var", torch.empty(c, device=device))

    def forward(self, x):
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        shape = (1, -1, 1, 1)
        return ((x - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


class _ConvNorm(nn.Module):
    def __init__(self, conv, norm):
        super().__init__()
        self.l, self.norm = conv, norm

    def forward(self, x):
        return self.norm(self.l(x))


class _Up(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


class _EncoderInput(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.input = conv


class _EncoderDown(nn.Module):
    def __init__(self, conv, norm):
        super().__init__()
        self.block = nn.ModuleList([nn.LeakyReLU(0.2), _ConvNorm(conv, norm)])


class _EncoderOut(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.down = nn.ModuleList([nn.LeakyReLU(0.2), conv])


class _Stage(nn.Module):
    def __init__(self, name, mods):
        super().__init__()
        setattr(self, name, nn.ModuleList(mods))
        self.mods = mods


class _Coder(nn.Module):
    pass


class Warper(nn.Module):
    """(N, H, W, 3) images -> planar flow (N, 2, H, W); `cfg` gives
    `warper_num_layers` L (the input is cut by 2^L)."""

    def __init__(self, cfg: dict, num: Numerics, device=None):
        super().__init__()
        layers = cfg["warper_num_layers"]
        widths = [64, 128, 256, 512] + [512] * (layers - 5)

        def conv(cin, cout, k, s, p, bias=False):
            return Conv(num, cin, cout, k, s, p, bias=bias, device=device)

        enc = _Coder()
        enc.down_list = nn.ModuleList(
            [_EncoderInput(conv(3, widths[0], 4, 2, 1))]
            + [_EncoderDown(conv(a, b, 4, 2, 1), WarperBN(b, device))
               for a, b in zip(widths[:-1], widths[1:])])
        enc.out = _EncoderOut(conv(widths[-1], 512, 4, 2, 1))
        self.encoder_d = enc
        dec = _Coder()
        stages, cin = [], 512
        for i, cout in enumerate([512] * (layers - 4) + [256, 128, 64]):
            width = cin if i == 0 else 2 * cin
            stages.append(_Stage("block", [
                nn.ReLU(), _Up(),
                _ConvNorm(conv(width, cout, 3, 1, 1), WarperBN(cout, device))]))
            cin = cout
        stages.append(_Stage("output", [nn.ReLU(), _Up(),
                                        conv(cin, 2, 3, 1, 1, bias=True)]))
        dec.up_list = nn.ModuleList(stages)
        self.decoder_d = dec

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        enc = self.encoder_d
        skips = []
        for i, stage in enumerate(enc.down_list):
            if i == 0:
                x = stage.input(x)
            else:
                act, cn = stage.block
                x = cn(act(x))
            skips.append(x)
        skips.reverse()
        act, last = enc.out.down
        out = last(act(x))
        *ups, final = self.decoder_d.up_list
        for i, stage in enumerate(ups):
            if i:
                out = torch.cat([skips[i - 1], out], dim=1)
            for m in stage.mods:
                out = m(out)
        for m in final.mods:
            out = m(out)
        return out


def identity_grid(n: int, device) -> torch.Tensor:
    """linspace(-1, 1, n) in float64, rounded to float32."""
    return torch.linspace(-1.0, 1.0, n, dtype=torch.float64,
                          device=device).float()


def upsample(logits: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear align-corners upsample of NCHW logits (the reference's
    `interp`)."""
    return F.interpolate(logits, size=tuple(hw), mode="bilinear",
                         align_corners=True)


def upsample_warp(logits: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The fork's warp of the upsampled logits: grid clamp(tanh(flow) +
    identity, -1, 1), bilinear align-corners sampling with zero padding."""
    h, w = flow.shape[2:]
    f = torch.tanh(flow)
    gx = torch.clamp(f[:, 0] + identity_grid(w, flow.device).view(1, 1, -1),
                     -1.0, 1.0)
    gy = torch.clamp(f[:, 1] + identity_grid(h, flow.device).view(1, -1, 1),
                     -1.0, 1.0)
    return F.grid_sample(upsample(logits, (h, w)), torch.stack([gx, gy], -1),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=True)
