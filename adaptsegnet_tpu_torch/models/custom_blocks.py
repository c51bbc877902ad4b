"""The Warper's norm and spectral-conv blocks.

Counterpart of the parts of adaptsegnet_tpu/models/custom_blocks.py that the
Warper uses (reference model/custom_layers.py): `InstanceNorm2d` (:74),
`SpectralConv2d` (:87) and `SpectralConvTranspose2d` (:139). The rest of that
module (`pixel_shuffle`, `PReLU`, `OneOneConvolution`, `Connection`,
`AdvancedDecoderOutput`, the discriminator blocks) is not ported yet.

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

from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    conv2d,
    conv_transpose4x4_stride2,
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
