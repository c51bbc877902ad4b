"""The f32 parity path's matmul/conv precision, in one place.

The JAX package runs its f32 path at an explicit MXU precision
(adaptsegnet_tpu/ops/precision.py) because the TPU would otherwise multiply
f32 operands in bf16. The card's trap is the mirror image: cuDNN runs f32
convolutions in TF32 by default (about three decimal digits), which would
break f32 mask parity silently on the card and never on the CPU. Building
an f32 model or eval fn therefore turns TF32 off for both cuDNN and cuBLAS.
The switches are process-wide; bf16 is unaffected by them.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_for(dtype: torch.dtype):
    """Let cuDNN use TF32 inside the block when `dtype` is a low-precision
    type whose values are being convolved as f32 upcasts: bf16 and f16
    values (and their products) are exact in TF32's 10 mantissa bits, so
    TF32 tensor cores change nothing there. f32 leaves the switch alone."""
    if dtype == torch.float32:
        yield
        return
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def configure(dtype: torch.dtype) -> None:
    """Set the process-wide TF32 switches for a compute dtype.

    f32 -> true f32 convolutions and matmuls (the parity path). Other dtypes
    leave the switches as they are.
    """
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
