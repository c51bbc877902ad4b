"""4x4 / stride-2 / pad-1 convolutions of the discriminator, differentiable.

Counterpart of adaptsegnet_tpu/ops/conv4x4.py::conv4x4_stride2 (`:68-111`,
the dispatch) and of the discriminator's conv1 dispatch
(adaptsegnet_tpu/models/discriminator.py:89-101):
  * `conv4x4_stride2(x, w, b)`: NHWC in and out. Kernel 5
    (ops/kernels/conv4x4_s2.py) for bf16 with 2*Cin % 128 == 0 and
    Cout % 128 == 0 (D conv2..conv4) in all three directions; a library
    conv otherwise (the 512 -> 1 classifier, the f32 path);
  * `conv4x4_patch(x, w, b)`: the planar (N, C, H, W) softmax map in, NHWC
    out. Kernel 4 (ops/kernels/conv4x4_patch.py) for bf16 with C <= 20 and
    64 outputs (D conv1) in all three directions; a library conv otherwise.
Both are `torch.autograd.Function`s that run only the directions autograd
asks for (`ctx.needs_input_grad`): the generator's loss has the D weights
frozen (no wgrad), the discriminator's losses detach the maps (no conv1
dgrad). The bias gradient is the f32 sum of dy (`conv4x4_s2.py:354-356`),
returned in the bias's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adaptsegnet_tpu_torch.ops.kernels import conv4x4_patch as k4
from adaptsegnet_tpu_torch.ops.kernels import conv4x4_s2 as k5


def _bias_grad(ctx, dy: torch.Tensor) -> torch.Tensor | None:
    if ctx.bias_dtype is None or not ctx.needs_input_grad[2]:
        return None
    return dy.float().sum(dim=(0, 1, 2)).to(ctx.bias_dtype)


class _Conv4x4S2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if b is None else b.dtype
        return k5.conv4x4_s2_fwd(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        need = ctx.needs_input_grad
        dx = k5.conv4x4_s2_dgrad(dy, w, x.shape[1:3]) if need[0] else None
        dw = k5.conv4x4_s2_wgrad(x, dy).to(w.dtype) if need[1] else None
        return dx, dw, _bias_grad(ctx, dy)


class _Conv4x4Patch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if b is None else b.dtype
        return k4.conv4x4_patch_fwd(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        need = ctx.needs_input_grad
        dx = k4.conv4x4_patch_dgrad(dy, w, x.shape[2:4]) if need[0] else None
        dw = k4.conv4x4_patch_wgrad(x, dy).to(w.dtype) if need[1] else None
        return dx, dw, _bias_grad(ctx, dy)


def conv4x4_stride2(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None) -> torch.Tensor:
    """torch Conv2d(Cin, Cout, 4, stride=2, padding=1) on NHWC x; w OIHW and
    b in x.dtype. Returns NHWC."""
    if k5.supported(x.shape, w.shape[0], x.dtype):
        return _Conv4x4S2.apply(x.contiguous(), w, b)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.contiguous(
        memory_format=torch.channels_last), b, 2, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv4x4_patch(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None) -> torch.Tensor:
    """The same conv on a planar (N, C, H, W) x (the D input); returns NHWC."""
    if k4.supported(x.shape, w.shape[0], x.dtype):
        return _Conv4x4Patch.apply(x.contiguous(), w, b)
    return F.conv2d(x, w, b, 2, 1).permute(0, 2, 3, 1).contiguous()
