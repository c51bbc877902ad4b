"""ASPP head forward: the sum of dilated 3x3 branch convs, summed in f32.

Counterpart of adaptsegnet_tpu/ops/aspp.py::aspp_matmul (`_aspp_fwd_impl`
:118-145). The JAX package lowers the four branches to one matmul plus
static shifts, a TPU lane-utilisation trick; on the card each branch is a
library convolution. What carries over is the arithmetic contract: the
products of the compute-dtype operands are accumulated in f32
(`preferred_element_type=f32`), the branch outputs and all their biases are
summed in f32, and the result is cast to the compute dtype once.

A bf16 convolution would round each branch's output to bf16 before the sum.
So for a low-precision input the branches convolve the operands upcast to
f32. That is exact: bf16 (and f16) values, and their products, are
representable in f32, and in TF32 too (10 mantissa bits), so cuDNN may use
TF32 tensor cores for these convs without changing a product.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


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
    low = x.dtype != torch.float32
    tf32 = torch.backends.cudnn.allow_tf32
    if low:
        torch.backends.cudnn.allow_tf32 = True  # exact here, see above
    try:
        xf = x.float()
        out = None
        for w, b, d in list(zip(weights, biases, dilations))[:n]:
            wf = w.to(x.dtype).float().contiguous(
                memory_format=torch.channels_last)
            y = F.conv2d(xf, wf, None, 1, d, d) + b.float().view(1, -1, 1, 1)
            out = y if out is None else out + y
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out.to(x.dtype)
