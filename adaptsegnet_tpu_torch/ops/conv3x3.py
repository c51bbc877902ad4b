"""Stride-1 3x3 conv (padding = dilation): the train path's, with its
backward, and the batched eval path's.

Counterpart of adaptsegnet_tpu/ops/conv3x3.py::conv3x3_s1 (`:91-145`), a
custom VJP there, a `torch.autograd.Function` here:
  * forward: kernel 2 (ops/kernels/conv3x3_dil.py) where it applies: bf16,
    d in {2, 4}, channels multiples of 128, i.e. the backbone's layer3 and
    layer4 3x3s; cuDNN otherwise (f32 with TF32 off, ops/precision.py; the
    d=1 convs of layer1 and layer2);
  * dgrad: kernel 2 again on the flipped, in/out-swapped weights, where the
    forward took it; cuDNN otherwise;
  * wgrad: a library call, as the JAX package leaves its nine dot_generals
    outside Pallas: accumulated in f32 and rounded once to the weight's
    dtype (`:124-141`). For bf16 the f32 convolution runs on the exact f32
    values of the bf16 operands (TF32 allowed there, `precision.tf32_for`).
Only directions autograd asks for run (`ctx.needs_input_grad`).

Where autograd does not record (eval under `torch.no_grad()` or
`torch.inference_mode()`), `conv3x3_s1` is a forward alone: kernel 3
(`conv3x3_dil_batched_fwd`) for a bf16 batch of two images or more with
d in {1, 2, 4} and channels multiples of 128, i.e. the layer2, layer3 and
layer4 3x3s of a batched bf16 eval, the path the JAX package built
`conv3x3_dil_mxu_batched` for (`:67-77`); cuDNN otherwise (batch 1, f32,
layer1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from adaptsegnet_tpu_torch.ops.kernels import conv3x3_dil
from adaptsegnet_tpu_torch.ops.precision import tf32_for

_CL = torch.channels_last


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW view -> contiguous NHWC (free for channels_last memory)."""
    return t.permute(0, 2, 3, 1).contiguous()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class Conv3x3S1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, d):
        """x: NCHW (channels_last memory), w: OIHW in x.dtype."""
        kernel = conv3x3_dil.supported(
            (x.shape[0], x.shape[2], x.shape[3], x.shape[1]), w.shape[0], d,
            x.dtype)
        ctx.d, ctx.kernel = d, kernel
        ctx.save_for_backward(x, w)
        if kernel:
            return _nchw(conv3x3_dil.conv3x3_dil_fwd(_nhwc(x), w, d))
        return F.conv2d(x, w.contiguous(memory_format=_CL), None, 1, d, d)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        d = ctx.d
        dy = dy.to(x.dtype).contiguous(memory_format=_CL)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.kernel:
                dx = _nchw(conv3x3_dil.conv3x3_dil_dgrad(_nhwc(dy), w, d))
            else:
                dx = conv2d_input(x.shape, w.contiguous(memory_format=_CL),
                                  dy, 1, d, d).to(x.dtype)
        if ctx.needs_input_grad[1]:
            with tf32_for(x.dtype):
                dw = conv2d_weight(x.float(), w.shape, dy.float(), 1, d, d)
            dw = dw.to(w.dtype)
        return dx, dw, None


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """conv3x3(x, w, stride 1, padding = dilation = d), differentiable.

    x: NCHW view in channels_last memory; w: OIHW (Cout, Cin, 3, 3) in the
    compute dtype. Returns NCHW in channels_last memory."""
    d = int(dilation)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return Conv3x3S1.apply(x, w, d)
    if conv3x3_dil.supported_batched(
            (x.shape[0], x.shape[2], x.shape[3], x.shape[1]), w.shape[0], d,
            x.dtype):
        return _nchw(conv3x3_dil.conv3x3_dil_batched_fwd(_nhwc(x), w, d))
    return F.conv2d(x, w.contiguous(memory_format=_CL), None, 1, d, d)
