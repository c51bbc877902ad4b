"""How the plain reference multiplies.

`Numerics()` is the reference: every convolution in float32, with TF32
off on the card (`strict_f32`), so that the reference is the function the
configuration describes and not the card's default of TF32 convolutions.

`Numerics(fp8=True)` is the control of `correct`: the same reference
computed in float8 e4m3 as the program computes in bfloat16: each
convolution's operands and its output are rounded to fp8 going forward,
and the gradients coming back to each of them going backward, one scale
per tensor (its largest magnitude at e4m3's largest finite value, 448),
with float32 accumulation inside the convolution. The program stores
every convolution's output in bf16; the control stores it in fp8: the
precision below the configuration's bf16 that a faster program could be
tempted to take.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` (float32) rounded to float8 e4m3 under one per-tensor scale, as
    float32 values."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8(torch.autograd.Function):
    """Rounds its input to fp8 going forward and the gradient going back."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


class Numerics:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def conv2d(self, x, w, b=None, stride=1, padding=0, dilation=1):
        if not self.fp8:
            return F.conv2d(x, w, b, stride, padding, dilation)
        y = F.conv2d(_Fp8.apply(x), _Fp8.apply(w), b, stride, padding, dilation)
        return _Fp8.apply(y)


@contextlib.contextmanager
def strict_f32():
    """TF32 off for cuDNN and cuBLAS inside the block (no effect on the
    CPU); the switches are restored after it."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
