"""ASPP head: the sum of dilated 3x3 branch convs, summed in f32, forward and
backward.

Counterpart of adaptsegnet_tpu/ops/aspp.py::aspp_matmul (`_aspp_fwd_impl`
:118-145, `_aspp_bwd` :181-229). The JAX package lowers the four branches to
one matmul plus static shifts, a TPU lane-utilisation trick; on the card each
branch is a library convolution. What carries over is the arithmetic
contract:
  * forward: the products of the compute-dtype operands are accumulated in
    f32 (`preferred_element_type=f32`), the branch outputs and all their
    biases are summed in f32, and the result is cast to the compute dtype
    once;
  * backward: the cotangent is taken in the compute dtype (`gc =
    g.astype(x.dtype)`), dx is the f32 sum over all branches cast once to
    the compute dtype, and each branch's weight and bias gradient is
    accumulated in f32 and returned in its parameter's dtype (f32 for the
    model's f32 parameters: no bf16 rounding of the head's weight grads).

A bf16 convolution would round each branch's output to bf16 before the sum.
So for a low-precision input every convolution here, forward and backward,
runs on the operands upcast to f32. That is exact: bf16 (and f16) values,
and their products, are representable in f32, and in TF32 too, so cuDNN may
use TF32 tensor cores for these convs without changing a product
(`precision.tf32_for`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from adaptsegnet_tpu_torch.ops.precision import tf32_for


def _low_f32(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """w rounded to the compute dtype as the JAX package rounds it, held as
    exact f32 values in channels_last."""
    return w.to(dtype).float().contiguous(memory_format=torch.channels_last)


class _AsppSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dilations, *params):
        n = len(dilations)
        weights, biases = params[:n], params[n:]
        ctx.dilations = dilations
        ctx.bias_dtypes = [b.dtype for b in biases]
        ctx.save_for_backward(x, *weights)
        with tf32_for(x.dtype):
            xf = x.float()
            out = None
            for w, b, d in zip(weights, biases, dilations):
                y = F.conv2d(xf, _low_f32(w, x.dtype), None, 1, d, d)
                y = y + b.float().view(1, -1, 1, 1)
                out = y if out is None else out + y
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        dils = ctx.dilations
        need = ctx.needs_input_grad
        n = len(dils)
        gf = g.to(x.dtype).float().contiguous(memory_format=torch.channels_last)
        dx, dws = None, []
        with tf32_for(x.dtype):
            if need[0]:
                for w, d in zip(weights, dils):
                    t = conv2d_input(x.shape, _low_f32(w, x.dtype), gf, 1, d, d)
                    dx = t if dx is None else dx + t
                dx = dx.to(x.dtype)
            xf = x.float()
            for i, (w, d) in enumerate(zip(weights, dils)):
                dws.append(conv2d_weight(xf, w.shape, gf, 1, d, d).to(w.dtype)
                           if need[2 + i] else None)
        db = gf.sum(dim=(0, 2, 3))
        dbs = [db.to(dt) if need[2 + n + i] else None
               for i, dt in enumerate(ctx.bias_dtypes)]
        return (dx, None, *dws, *dbs)


def aspp_sum(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    dilations: Sequence[int],
    n_sum: int | None = None,
) -> torch.Tensor:
    """sum_b conv3x3(x, weights[b], padding=dilation=d_b) + biases[b].

    x: NCHW (channels_last memory) in the compute dtype; weights OIHW f32,
    rounded to the compute dtype as the JAX package rounds them. Returns the
    compute dtype. `n_sum` limits the sum to the first n branches (the
    reference's early-return quirk, 'first2'); DeeplabMulti sums all four.
    """
    n = len(weights) if n_sum is None else int(n_sum)
    return _AsppSum.apply(x, tuple(dilations[:n]), *weights[:n], *biases[:n])
