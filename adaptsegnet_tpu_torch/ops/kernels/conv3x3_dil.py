"""Dilated 3x3 stride-1 convolution on bf16 tensor cores: kernels 2 and 3.

Replaces the TPU kernels of adaptsegnet_tpu/ops/pallas/conv3x3_dil.py
(`conv3x3_dil_mxu` and `conv3x3_dil_mxu_batched`): conv3x3(x, w, stride 1,
padding = dilation = d) on NHWC bf16 with f32 accumulation and one rounding
to bf16. The CUDA source is csrc/conv3x3_dil.cu, an implicit GEMM on the
Hopper core csrc/igemm_sm90.cuh (wgmma, TMA weights, cp.async gather); its
note gives the design. The products bound it (989 TFLOP/s bf16); the tile
is chosen here (`tile_plan`) so that the grid fills the card at one image
as at four. ops/conv3x3.py routes the backbone's layer3 (d=2) and layer4
(d=4) 3x3 convs to kernel 2 on the train path, forward and dgrad, and the
layer2 (d=1), layer3 and layer4 3x3 convs of a bf16 batch of two images or
more to kernel 3 where autograd does not record (batched eval).

Three wrappers, each with its own launch count: `conv3x3_dil_fwd(x, w, d)`,
`conv3x3_dil_dgrad(dy, w, d)`, the same kernel on the io-swapped weights
with the taps mirrored in the gather, and `conv3x3_dil_batched_fwd(x, w, d,
nb)`, the forward with the batch flattened into the GEMM's rows (`nb` is
validated as the JAX function validates it, and does not change the
launch). A CPU tensor takes the plain PyTorch version (`conv3x3_dil_plain`:
f32 convolution of the bf16 values, exact products, one rounding); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from adaptsegnet_tpu_torch.ops.kernels import _build
from adaptsegnet_tpu_torch.ops.kernels.conv4x4_s2 import BM, BN, SMS


def conv3x3_dil_plain(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """(N, H, W, Cin) NHWC x, OIHW (Cout, Cin, 3, 3) w -> (N, H, W, Cout) in
    x.dtype: the conv of the exact f32 values, rounded once."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), None, 1, d, d)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the dgrad's (Cin, Cout, 3, 3): flipped in
    space, in and out channels swapped (adaptsegnet_tpu/ops/conv3x3.py:115)."""
    return w.flip(2, 3).transpose(0, 1)


def supported(x_shape, cout: int, d: int, dtype: torch.dtype) -> bool:
    """The shapes the kernel takes: bf16, d in {2, 4}, channels multiples of
    128 (the convs the JAX package routes to its kernel,
    ops/pallas/conv3x3_dil.py:70-93, without its TPU row-blocking terms)."""
    cin = x_shape[-1]
    return (dtype == torch.bfloat16 and d in (2, 4) and cin % 128 == 0
            and cout % 128 == 0)


def pick_nb(n: int) -> int:
    """The JAX kernel's images per grid block: the largest of 8, 4, 2 that
    divides the batch, else 1 (the JAX `_pick_nb`,
    ops/pallas/conv3x3_dil.py:130, without its VMEM term). Here it gates
    the batched forward and validates `nb`; the launch does not use it."""
    for nb in (8, 4, 2):
        if n % nb == 0:
            return nb
    return 1


def supported_batched(x_shape, cout: int, d: int, dtype: torch.dtype) -> bool:
    """The shapes the batched forward takes: bf16, d in {1, 2, 4}, channels
    multiples of 128, a batch of two or more that 2, 4 or 8 divides (the JAX
    gate, ops/pallas/conv3x3_dil.py:144-158, without its TPU row-blocking
    terms)."""
    n, cin = x_shape[0], x_shape[-1]
    return (dtype == torch.bfloat16 and d in (1, 2, 4) and cin % 128 == 0
            and cout % 128 == 0 and n >= 2 and pick_nb(n) > 1)


def tile_plan(m: int, cout: int) -> tuple[int, int]:
    """The (bm, bn) tile of the Hopper core for an (m, 9*Cin) @ (9*Cin,
    cout) implicit GEMM, kernels 2 and 3 alike: 128 x 256 where Cout allows
    it and that grid still holds about one full wave (>= 0.9 * SMS blocks),
    else 128 x 128. The wider tile halves the gather's traffic per product;
    at one image (m = 8,192) it would leave layer3 with 64 blocks."""
    blocks = -(-m // BM) * (cout // (2 * BN))
    wide = cout % (2 * BN) == 0 and 10 * blocks >= 9 * SMS
    return BM, 2 * BN if wide else BN


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("conv3x3_dil")
    lib.asn_conv3x3_dil.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.asn_conv3x3_dil.restype = ctypes.c_int
    return lib


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the core's K-major (Cout, 9*Cin), column
    (ky*3 + kx)*Cin + ci. The dgrad passes the io-swapped w.transpose(0, 1),
    (Cin, 9*Cout): one copy, the spatial flip being the gather's."""
    cout, cin = w.shape[:2]
    return w.permute(0, 2, 3, 1).reshape(cout, 9 * cin)


def _launch(x: torch.Tensor, w: torch.Tensor, d: int, what: str,
            flip: bool = False) -> torch.Tensor:
    """Launch the core on (x, w): the forward conv, or with `flip` the conv
    with the taps mirrored (the dgrad, given the io-swapped weights)."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3) or cin % 64 or cout % 8:
        raise ValueError(f"{what}: unsupported weight {tuple(w.shape)} for "
                         f"input {tuple(x.shape)}")
    wt = kmajor_weights(w).contiguous()
    _build.check_operands(what, x.device, x=x, w=wt)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    _, bn = tile_plan(n * h * wd, cout)
    _build.raise_on(_library().asn_conv3x3_dil(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
        int(d), int(flip), bn, _build.stream(x)), what)
    return out


def conv3x3_dil_fwd(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """(N, H, W, Cin) NHWC, OIHW w -> (N, H, W, Cout): the forward conv."""
    if not _build.on_cuda(x, "conv3x3_dil_fwd"):
        return conv3x3_dil_plain(x, w, d)
    out = _launch(x, w, d, "conv3x3_dil_fwd")
    conv3x3_dil_fwd.launches += 1
    return out


def conv3x3_dil_dgrad(dy: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """(N, H, W, Cout) NHWC cotangent, the forward's OIHW w -> dx
    (N, H, W, Cin): the forward's core on the io-swapped weights, the
    taps mirrored in the gather (the conv with the flipped weights)."""
    if not _build.on_cuda(dy, "conv3x3_dil_dgrad"):
        return conv3x3_dil_plain(dy, flip_weights(w), d)
    out = _launch(dy, w.transpose(0, 1), d, "conv3x3_dil_dgrad", flip=True)
    conv3x3_dil_dgrad.launches += 1
    return out


def conv3x3_dil_batched_fwd(x: torch.Tensor, w: torch.Tensor, d: int,
                            nb: int | None = None) -> torch.Tensor:
    """(N, H, W, Cin) NHWC with N >= 2, OIHW w -> (N, H, W, Cout): the
    forward conv over the whole batch. Forward only: the eval path's
    kernel. `nb` (None: `pick_nb(N)`) only mirrors the JAX function's API,
    images per grid block there: it must divide N, and the result does not
    depend on it."""
    n = x.shape[0]
    nb = pick_nb(n) if nb is None else int(nb)
    if n < 2 or nb < 1 or n % nb:
        raise ValueError(f"conv3x3_dil_batched_fwd: a batch of {n} in groups "
                         f"of {nb}")
    if not _build.on_cuda(x, "conv3x3_dil_batched_fwd"):
        return conv3x3_dil_plain(x, w, d)
    out = _launch(x, w, d, "conv3x3_dil_batched_fwd")
    conv3x3_dil_batched_fwd.launches += 1
    return out


conv3x3_dil_fwd.launches = 0
conv3x3_dil_dgrad.launches = 0
conv3x3_dil_batched_fwd.launches = 0
