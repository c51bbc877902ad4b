"""The custom conv-layer zoo (reference model/custom_layers.py).

Counterpart of adaptsegnet_tpu/models/custom_blocks.py. The Warper uses
`InstanceNorm2d` (:74), `SpectralConv2d` (:87) and `SpectralConvTranspose2d`
(:139); the rest of the zoo, which the reference builds but never calls,
is here for its capability and state-dict surface: `pixel_shuffle` (:52),
`PReLU` (:65), `OneOneConvolution` (:188, with the unused ReLU + 1x1
`one_one` branch's parameters), `Connection` (:211), `AdvancedDecoderOutput`
(:234), `DownDiscriminatorBlock` (:267) and `KeepDiscriminatorBlock` (:290),
the last two in Batch and Spectral norm. Like the Warper's modules they run
on NCHW views in channels_last memory, `forward(x, dtype)` computing in the
compute dtype with f32 parameters, the BN in train mode when the module is
(`WarperBatchNorm2d`). Their state-dict keys are torch's for the same
structure; utils/pth_interop.py::from_jax_variables carries flax trees of
the JAX blocks across to them.

Spectral normalisation follows torch's nn.utils.spectral_norm as the JAX
package does: one power iteration per call on the (Cout, fan_in) weight
matrix with a persistent `u` buffer (eps 1e-12), `u` written back only in
train mode; for the transposed conv the matrix is viewed with Cout first
(dim=1), so `u` has length Cout in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adaptsegnet_tpu_torch.device import resolve_device
from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    WarperBatchNorm2d,
    conv2d,
    conv_transpose4x4_stride2,
    init_torch_default_,
    leaky_relu,
    xavier_normal_,
)

_EPS = 1e-12


class InstanceNorm2d(nn.Module):
    """torch InstanceNorm2d(affine=False): per (sample, channel) over H, W,
    in f32, rounded once to x's dtype. No parameters."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def _spectral_weight(module: nn.Module, cout_first: torch.Tensor) -> torch.Tensor:
    """weight / sigma with one power iteration from module.u (updated in
    place in train mode). `cout_first` is the f32 weight with Cout on axis
    0; sigma does not depend on the order of the fan_in axis."""
    w = cout_first.reshape(cout_first.shape[0], -1)
    v = w.t() @ module.u
    v = v / (torch.linalg.vector_norm(v) + _EPS)
    wv = w @ v
    u_new = wv / (torch.linalg.vector_norm(wv) + _EPS)
    if module.training:
        with torch.no_grad():
            module.u.copy_(u_new)
    sigma = torch.dot(u_new.detach(), wv)
    return module.weight.float() / sigma


class SpectralConv2d(Conv2d):
    """Conv2d with spectral normalisation; keys `weight`, `bias`, `u`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding, bias=True)
        self.register_buffer("u", torch.zeros(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = _spectral_weight(self, self.weight.float())
        # JAX's SpectralConv2d is a plain conv (never the 4x4 kernel route).
        return F.conv2d(x.to(dtype), w.to(dtype), self.bias.to(dtype),
                        self.stride, self.padding)


class SpectralConvTranspose2d(ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1) with spectral normalisation over
    dim=1 (Cout); keys `weight` (Cin, Cout, 4, 4), `bias`, `u`."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, bias=True)
        self.register_buffer("u", torch.zeros(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = _spectral_weight(self, self.weight.float().transpose(0, 1))
        return conv_transpose4x4_stride2(x, self, dtype, weight=w)


def apply_conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run any of the Warper's conv holders on an NCHW view."""
    if isinstance(conv, (SpectralConv2d, SpectralConvTranspose2d)):
        return conv(x, dtype)
    if isinstance(conv, ConvTranspose2d):
        return conv_transpose4x4_stride2(x, conv, dtype)
    return conv2d(x, conv, dtype)


# ------------------------------------------------- the rest of the zoo


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """torch nn.PixelShuffle on an NCHW view: (N, C r^2, H, W) -> (N, C,
    rH, rW), channels unpacked in (c, r, r) order; channels_last out."""
    return F.pixel_shuffle(x, upscale).contiguous(
        memory_format=torch.channels_last)


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope (`weight`, torch's default
    0.25): where(x >= 0, x, a x) in x's dtype."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.weight.to(x.dtype))


def _init_(module: nn.Module, generator: torch.Generator | None,
           device) -> None:
    """The Warper's init law on a block: xavier normal (gain 0.02) convs,
    BN weight ~ N(1, 0.02), spectral u ~ N(0, 1); then onto `device`."""
    g = torch.Generator().manual_seed(0) if generator is None else generator
    xavier_normal_(module, g)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, WarperBatchNorm2d):
                m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape,
                                                        generator=g))
            elif isinstance(m, (SpectralConv2d, SpectralConvTranspose2d)):
                m.u.copy_(torch.randn(m.u.shape, generator=g))
    module.to(resolve_device(device))


class OneOneConvolution(nn.Module):
    """1x1 conv (`input`); the ReLU + 1x1 `one_one` branch is built but
    never applied, as in the reference. torch's default init for both
    kernels, biases 0 (JAX :188-209)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.input = Conv2d(cin, cout, 1, bias=bias)
        self.one_one = nn.Sequential(nn.ReLU(), Conv2d(cin, cout, 1, bias=bias))
        g = torch.Generator().manual_seed(0) if generator is None else generator
        init_torch_default_(self, g)
        with torch.no_grad():
            for conv in (self.input, self.one_one[1]):
                if conv.bias is not None:
                    conv.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return conv2d(x, self.input, dtype)


class Connection(nn.Module):
    """The per-skip 1x1 projections (reference warper.py:15-33):
    num_layers - 3 OneOneConvolution(512 -> warp_channels) in `container`.
    Projection i maps warp_list[i + 1]; warp_list[-1] passes through (the
    reference's loop would index past its list; JAX :211-232)."""

    def __init__(self, num_layers: int = 6, warp_channels: int = 2,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        out_ch = warp_channels if warp_channels else 2 * 512
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.container = nn.ModuleList(
            OneOneConvolution(512, out_ch, device="cpu", generator=g)
            for _ in range(num_layers - 3))
        self.to(resolve_device(device))

    def forward(self, warp_list, dtype: torch.dtype = torch.float32):
        return [proj(warp_list[i + 1], dtype)
                for i, proj in enumerate(self.container)] + [warp_list[-1]]


class AdvancedDecoderOutput(nn.Module):
    """The pixel-shuffle decoder head (reference custom_layers.py:191-230;
    JAX :234-264): ReLU -> 3x3 conv to 64 + BN + PReLU, a residual block
    (conv, BN, PReLU, conv, BN), 3x3 conv to 256 -> PixelShuffle(2) ->
    PReLU -> 9x9 conv (with bias) to out_ch."""

    def __init__(self, cin: int, out_ch: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_conv = Conv2d(cin, 64, 3, padding=1)
        self.input_bn = WarperBatchNorm2d(64)
        self.input_prelu = PReLU()
        self.res_conv1 = Conv2d(64, 64, 3, padding=1)
        self.res_bn1 = WarperBatchNorm2d(64)
        self.res_prelu = PReLU()
        self.res_conv2 = Conv2d(64, 64, 3, padding=1)
        self.res_bn2 = WarperBatchNorm2d(64)
        self.shuffle_conv = Conv2d(64, 256, 3, padding=1)
        self.shuffle_prelu = PReLU()
        self.output_conv = Conv2d(64, out_ch, 9, padding=4, bias=True)
        _init_(self, generator, device)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        h = conv2d(F.relu(x), self.input_conv, dtype)
        h = self.input_prelu(self.input_bn(h))
        r = self.res_prelu(self.res_bn1(conv2d(h, self.res_conv1, dtype)))
        h = h + self.res_bn2(conv2d(r, self.res_conv2, dtype))
        h = pixel_shuffle(conv2d(h, self.shuffle_conv, dtype), 2)
        return conv2d(self.shuffle_prelu(h), self.output_conv, dtype)


class _DiscriminatorBlock(nn.Module):
    """4x4 conv + norm + LeakyReLU(0.2): 'Batch' (conv without bias, then
    the live BN) or 'Spectral' (spectral-norm conv with bias, no BN)."""

    stride = 2

    def __init__(self, cin: int, cout: int, norm: str = "Batch", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if norm not in ("Batch", "Spectral"):
            raise NotImplementedError(f"discriminator block norm {norm!r}")
        if norm == "Spectral":
            self.conv = SpectralConv2d(cin, cout, 4, stride=self.stride,
                                       padding=1)
            self.bn = None
        else:
            self.conv = Conv2d(cin, cout, 4, stride=self.stride, padding=1)
            self.bn = WarperBatchNorm2d(cout)
        _init_(self, generator, device)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        y = apply_conv(self.conv, x, dtype)
        return leaky_relu(y if self.bn is None else self.bn(y), 0.2)


class DownDiscriminatorBlock(_DiscriminatorBlock):
    """4x4 / stride-2 conv + norm + LeakyReLU(0.2) (reference
    custom_layers.py:238-251; JAX :267-287)."""

    stride = 2


class KeepDiscriminatorBlock(_DiscriminatorBlock):
    """4x4 / stride-1 / padding-1 conv + norm + LeakyReLU(0.2): the map
    shrinks by one, as in the reference (custom_layers.py:254-267; JAX
    :290-310)."""

    stride = 1
