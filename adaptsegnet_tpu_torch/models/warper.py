"""Flow-field Warper: a U-Net encoder/decoder that predicts a 2-channel flow.

Counterpart of adaptsegnet_tpu/models/warper.py (`WarperEncoder` :120,
`WarperDecoder` :158, `Warper` :254; reference model/warper.py,
model/custom_layers.py), with its `planar_flow=True` head: the flow comes out
planar (N, 2, H, W), channel 0 displacing x (width), channel 1 y (height),
for ops/upsample_warp.py. The flow head is the library 3x3 conv's NCHW
output, which is the planar layout JAX's ops/planar_out_conv.py builds by
hand on the TPU, so no module stands for that file here.

Architecture for `num_layers` L (8 in the fork's defaults):
  * encoder: L-1 convs 4x4/s2/p1, widths 64, 128, 256, 512, then 512s, each
    after the first preceded by LeakyReLU(0.2) and followed by the norm;
    the outputs are the skips (deepest first); then LeakyReLU and the `out`
    conv (512). Total downsampling 2^L (512x1024 -> a 2x4 latent). In bf16
    the convs with 2*Cin and Cout multiples of 128 (down1 .. out) run
    kernel 5 through models/layers.py::conv2d; down0 (Cin 3) is a library
    conv, as in JAX.
  * decoder: L-1 up stages (512s, then 256, 128, 64), each ReLU -> x2
    half-pixel bilinear upsample -> 3x3 conv -> norm (transpose=True:
    ReLU -> ConvTranspose 4x4/s2/p1 -> norm), the skip of the same size
    concatenated in front of stages 1 .. L-2; Dropout(0.5) after stages
    1 .. L-2 when `use_dropout`; then the output stage (ReLU -> x2 -> 3x3
    conv 64 -> 2 with bias).
  * norm 'Batch' (bias-free convs + the live BN of
    models/layers.py::WarperBatchNorm2d), 'Instance' (biased convs +
    InstanceNorm) or 'Spectral' (spectral-normalised biased convs, no norm).

Train mode (`warper.train()`, the default) normalises by batch statistics and
updates the running statistics (and the spectral `u` vectors); the train
step never optimises the Warper's weights. Input: NHWC images whose H and W
are multiples of 2^L, L >= 5 (the latent is at least 1x1 and every skip
meets an upsampled map of its size); other sizes raise ValueError.

State-dict keys are the reference's (the regexes of
adaptsegnet_tpu/utils/pth_interop.py:210-215), so a reference Warper `.pth`
loads: `encoder_d.down_list.0.input.*`,
`encoder_d.down_list.{i}.block.1.{l,norm}.*`, `encoder_d.out.down.1.*`,
`decoder_d.up_list.{i}.block.{2,1}.{l,norm}.*` (upsample + conv, or
transposed conv) and `decoder_d.up_list.{L-1}.output.{2,1}.*`. The
activation and upsample modules that fill the lower indices hold nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adaptsegnet_tpu_torch.device import resolve_device
from adaptsegnet_tpu_torch.models.custom_blocks import (
    InstanceNorm2d,
    SpectralConv2d,
    SpectralConvTranspose2d,
    apply_conv,
)
from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    WarperBatchNorm2d,
    xavier_normal_,
)
from adaptsegnet_tpu_torch.ops import precision
from adaptsegnet_tpu_torch.ops.resize import resize_bilinear_half_pixel

NORMS = ("Batch", "Instance", "Spectral")


class _Upsample2x(nn.Module):
    """x2 half-pixel bilinear upsample of an NCHW view: exact (f32
    matrices) for f32, in the dtype for bf16 (JAX `exact=dtype == f32`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        y = resize_bilinear_half_pixel(x.permute(0, 2, 3, 1), (2 * h, 2 * w),
                                       exact=x.dtype == torch.float32)
        return y.permute(0, 3, 1, 2)


class _ConvNorm(nn.Module):
    """The reference's conv block: `l` (the conv) then `norm` (or none)."""

    def __init__(self, conv: nn.Module, norm: nn.Module | None):
        super().__init__()
        self.l = conv
        self.norm = norm

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = apply_conv(self.l, x, dtype)
        return y if self.norm is None else self.norm(y)


def _norm(kind: str, c: int) -> nn.Module | None:
    return {"Batch": lambda: WarperBatchNorm2d(c),
            "Instance": InstanceNorm2d,
            "Spectral": lambda: None}[kind]()


class _EncoderInput(nn.Module):
    def __init__(self, conv: nn.Module):
        super().__init__()
        self.input = conv

    def forward(self, x, dtype):
        return apply_conv(self.input, x, dtype)


class _EncoderDown(nn.Module):
    def __init__(self, conv: nn.Module, norm: nn.Module | None):
        super().__init__()
        self.block = nn.ModuleList([nn.LeakyReLU(0.2), _ConvNorm(conv, norm)])

    def forward(self, x, dtype):
        return self.block[1](self.block[0](x), dtype)


class _EncoderOut(nn.Module):
    def __init__(self, conv: nn.Module):
        super().__init__()
        self.down = nn.ModuleList([nn.LeakyReLU(0.2), conv])

    def forward(self, x, dtype):
        return apply_conv(self.down[1], self.down[0](x), dtype)


class WarperEncoder(nn.Module):
    """SkipConnectionEncode: forward(x) -> (latent, skips deepest first)."""

    def __init__(self, num_layers: int = 8, out_channel: int = 512,
                 norm: str = "Batch"):
        super().__init__()
        spectral = norm == "Spectral"

        def conv(cin, cout):
            if spectral:
                return SpectralConv2d(cin, cout, 4, stride=2, padding=1)
            return Conv2d(cin, cout, 4, stride=2, padding=1,
                          bias=norm != "Batch")

        widths = [64, 128, 256, 512] + [512] * (num_layers - 5)
        stages = [_EncoderInput(conv(3, widths[0]))]
        for cin, cout in zip(widths[:-1], widths[1:]):
            stages.append(_EncoderDown(conv(cin, cout), _norm(norm, cout)))
        self.down_list = nn.ModuleList(stages)
        self.out = _EncoderOut(conv(widths[-1], out_channel))

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        skips = []
        for stage in self.down_list:
            x = stage(x, dtype)
            skips.append(x)
        skips.reverse()
        return self.out(x, dtype), skips


class _DecoderStage(nn.Module):
    """An up stage (`block`) or the output stage (`output`): ReLU, then the
    x2 upsample and a 3x3 conv, or a 4x4/s2 transposed conv."""

    def __init__(self, name: str, cin: int, cout: int, norm: str,
                 transpose: bool, output: bool):
        super().__init__()
        use_norm = not output
        if transpose:
            if norm == "Spectral" and use_norm:
                conv = SpectralConvTranspose2d(cin, cout)
            else:
                conv = ConvTranspose2d(cin, cout,
                                       bias=output or norm == "Instance")
            mods = [nn.ReLU()]
        else:
            if norm == "Spectral" and use_norm:
                conv = SpectralConv2d(cin, cout, 3, padding=1)
            else:
                conv = Conv2d(cin, cout, 3, padding=1,
                              bias=output or norm == "Instance")
            mods = [nn.ReLU(), _Upsample2x()]
        mods.append(conv if output else
                    _ConvNorm(conv, _norm(norm, cout) if use_norm else None))
        setattr(self, name, nn.ModuleList(mods))
        self._name = name

    def forward(self, x, dtype):
        *pre, last = getattr(self, self._name)
        for m in pre:
            x = m(x)
        return last(x, dtype) if isinstance(last, _ConvNorm) else apply_conv(
            last, x, dtype)


class WarperDecoder(nn.Module):
    """SkipConnectionDecode: forward(latent, skips) -> (flow, warp_list)."""

    def __init__(self, num_layers: int = 7, out_channel: int = 2,
                 norm: str = "Batch", transpose: bool = False,
                 use_dropout: bool = False,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        plan = [512] * (num_layers - 3) + [256, 128, 64]
        cin = 512
        stages = []
        for i, cout in enumerate(plan):
            width = cin if i == 0 else 2 * cin  # the skip is concatenated
            stages.append(_DecoderStage("block", width, cout, norm, transpose,
                                        output=False))
            cin = cout
        stages.append(_DecoderStage("output", cin, out_channel, norm,
                                    transpose, output=True))
        self.up_list = nn.ModuleList(stages)
        self.use_dropout = use_dropout
        self.dropout_generator = dropout_generator

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        """flax Dropout(0.5) in train mode: keep with p 0.5, scale by 2."""
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            0.5, generator=self.dropout_generator)
        return (x * (2.0 * keep).to(x.dtype)).contiguous(
            memory_format=torch.channels_last)

    def forward(self, latent, skips, dtype):
        out = latent
        warp_list = [out]
        *ups, last = self.up_list
        for i, stage in enumerate(ups):
            if i != 0:
                out = torch.cat([skips[i - 1], out], dim=1)
            out = stage(out, dtype)
            if self.use_dropout and self.training and i != 0:
                out = self._dropout(out)
            warp_list.append(out)
        return last(out, dtype), warp_list


class Warper(nn.Module):
    """forward(images (N, H, W, 3)) -> (flow (N, 2, H, W), warp_list).

    `dtype` is the compute dtype (parameters stay f32). Weights are drawn
    from `generator` with the reference's xavier law (gain 0.02; BN weight
    ~ N(1, 0.02)); spectral `u` vectors ~ N(0, 1) from the same generator.
    `device` as for DeeplabMulti (default: the CUDA card, raises without).
    `dropout_generator` (on `device`) draws the Dropout masks (off by
    default). In a data-parallel group each rank passes its own generator,
    seeded with the run's seed + its rank, so the ranks draw different
    masks for their images, as the devices of a JAX mesh draw from one
    key over the global batch; the parity tests run with dropout off."""

    def __init__(self, num_layers: int = 8, norm: str = "Batch",
                 transpose: bool = False, use_dropout: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        device = resolve_device(device)
        if norm not in NORMS:
            raise NotImplementedError(f"Warper norm {norm!r} (one of {NORMS})")
        if num_layers < 5:
            raise ValueError(f"Warper num_layers {num_layers} < 5")
        super().__init__()
        self.dtype, self.num_layers = dtype, num_layers
        self.encoder_d = WarperEncoder(num_layers, norm=norm)
        self.decoder_d = WarperDecoder(
            num_layers - 1, norm=norm, transpose=transpose,
            use_dropout=use_dropout, dropout_generator=dropout_generator)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        xavier_normal_(self, g)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, WarperBatchNorm2d):
                    m.weight.copy_(1.0 + 0.02 * torch.randn(
                        m.weight.shape, generator=g))
                elif isinstance(m, (SpectralConv2d, SpectralConvTranspose2d)):
                    m.u.copy_(torch.randn(m.u.shape, generator=g))
        precision.configure(dtype)
        self.to(device)

    def check_size(self, hw: tuple[int, int]) -> None:
        step = 2 ** self.num_layers
        if hw[0] % step or hw[1] % step:
            raise ValueError(
                f"the Warper (num_layers {self.num_layers}) needs H and W "
                f"multiples of {step}, got {tuple(hw)}")

    def forward(self, images: torch.Tensor):
        self.check_size(images.shape[1:3])
        x = images.contiguous().permute(0, 3, 1, 2).to(self.dtype)
        latent, skips = self.encoder_d(x, self.dtype)
        flow, warp_list = self.decoder_d(latent, skips, self.dtype)
        return flow.contiguous(), warp_list
