"""4x4 / stride-2 / pad-1 convolution on bf16 tensor cores: kernel 5.

Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/conv4x4_s2.py
(`conv4x4_s2_mxu`, forward, wgrad and dgrad): torch Conv2d(k=4, s=2, p=1) on
NHWC bf16 with f32 accumulation, the discriminator's conv2..conv4 and the
Warper encoder's down1..out. The CUDA source is csrc/conv4x4_s2.cu; its note
gives the design of each direction (forward and dgrad on the Hopper core,
csrc/igemm_sm90.cuh, which reads K-major weights).

Three wrappers, each with its own launch count:
  conv4x4_s2_fwd(x, w, b)      (N, H, W, Cin) -> (N, H/2, W/2, Cout) bf16,
                               the f32 bias added before the one rounding;
                               K split by `fwd_plan` where the tiles cannot
                               fill the card (one count per call, whatever
                               it launches on the device);
  conv4x4_s2_dgrad(dy, w, hw)  -> dx (N, H, W, Cin) bf16 (gather form);
  conv4x4_s2_wgrad(x, dy)      -> dW (Cout, Cin, 4, 4) f32 (split-K over the
                               pixels, partials summed in order).
Weights are OIHW in bf16. A CPU tensor takes the plain PyTorch version of
each (f32 convolutions of the bf16 values: exact products, f32 sums, one
rounding where the kernel rounds); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from adaptsegnet_tpu_torch.ops.kernels import _build

_WGRAD_PIXELS_PER_SPLIT = 1024
# The Hopper core's tile (csrc/igemm_sm90.cuh) and the card's SMs (H100 SXM).
BM, BN, BK, SMS = 128, 128, 64, 132


def supported(x_shape, cout: int, dtype: torch.dtype) -> bool:
    """bf16, 2*Cin % 128 == 0, Cout % 128 == 0, even H and W: D conv2..4
    (the JAX gate, ops/pallas/conv4x4_s2.py:54-68, without its TPU terms)."""
    n, h, w, cin = x_shape
    return (dtype == torch.bfloat16 and (2 * cin) % 128 == 0
            and cout % 128 == 0 and h % 2 == 0 and w % 2 == 0)


# ------------------------------------------------------------ plain versions


def conv4x4_s2_fwd_plain(x, w, b):
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(),
                 None if b is None else b.float(), 2, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv4x4_s2_dgrad_plain(dy, w, hw):
    n, ho, wo, cout = dy.shape
    dx = conv2d_input((n, w.shape[1]) + tuple(hw), w.float(),
                      dy.permute(0, 3, 1, 2).float(), 2, 1)
    return dx.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


def conv4x4_s2_wgrad_plain(x, dy):
    cout, cin = dy.shape[-1], x.shape[-1]
    return conv2d_weight(x.permute(0, 3, 1, 2).float(), (cout, cin, 4, 4),
                         dy.permute(0, 3, 1, 2).float(), 2, 1)


# ------------------------------------------------------------------ kernels


def fwd_plan(m: int, k: int, cout: int) -> tuple[int, int, int]:
    """(bm, splits, per) of the forward's launch for an (m, k) @ (k, cout)
    implicit GEMM: the row tile (64 where m fits one wgmma M, else 128),
    the number of K ranges and the K steps of 64 in each. Where the tiles
    leave more than half the card's SMs idle, K is cut into ranges of
    whole K steps, the most per range that still gives >= SMS blocks (one
    at least); every step lies in exactly one range, none is empty."""
    bm = 64 if m <= 64 else BM
    tiles = -(-m // bm) * -(-cout // BN)
    steps = k // BK
    if 2 * tiles > SMS:
        return bm, 1, steps
    per = max(1, steps // -(-SMS // tiles))
    return bm, -(-steps // per), per


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 4, 4) -> the forward's K-major (Cout, 16*Cin), column
    (ky*4 + kx)*Cin + ci: the transpose of the (K, Cout) weight matrix."""
    cout, cin = w.shape[:2]
    return w.permute(0, 2, 3, 1).reshape(cout, 16 * cin)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("conv4x4_s2")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asn_conv4x4_s2_fwd.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.asn_conv4x4_s2_dgrad.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.asn_conv4x4_s2_wgrad.argtypes = [p] * 4 + [i] * 6 + [p]
    for fn in (lib.asn_conv4x4_s2_fwd, lib.asn_conv4x4_s2_dgrad,
               lib.asn_conv4x4_s2_wgrad):
        fn.restype = i
    return lib


def conv4x4_s2_fwd(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None) -> torch.Tensor:
    what = "conv4x4_s2_fwd"
    if not _build.on_cuda(x, what):
        return conv4x4_s2_fwd_plain(x, w, b)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if (tuple(w.shape) != (cout, cin, 4, 4) or not supported(x.shape, cout, x.dtype)):
        raise ValueError(f"{what}: unsupported {tuple(x.shape)} -> {tuple(w.shape)}")
    wt = kmajor_weights(w).contiguous()
    _build.check_operands(what, x.device, x=x, w=wt)
    bias = None if b is None else b.to(x.device, torch.float32).contiguous()
    m = n * (h // 2) * (wd // 2)
    bm, splits, per = fwd_plan(m, 16 * cin, cout)
    ws = (torch.empty((splits, m, cout), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=x.dtype, device=x.device)
    _build.raise_on(_library().asn_conv4x4_s2_fwd(
        x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        n, h, wd, cin, cout, bm, splits, per, _build.stream(x)), what)
    conv4x4_s2_fwd.launches += 1
    return out


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 4, 4) -> the dgrad's K-major matrices (4, Cin,
    4*Cout): for parity class z = 2*py + px, column block 2a + b holds
    W[:, :, 1 - py + 2a, 1 - px + 2b].T (the taps whose stride-2 source
    reaches a dx pixel of that parity). With ky = 2a + ry the class's taps
    are those with ry = 1 - py, so one reshape, permute and flip build all
    four, in one copy."""
    cout, cin = w.shape[:2]
    w6 = w.reshape(cout, cin, 2, 2, 2, 2)          # (co, ci, a, ry, b, rx)
    w6 = w6.permute(3, 5, 1, 2, 4, 0).flip(0, 1)   # (py, px, ci, a, b, co)
    return w6.reshape(4, cin, 4 * cout)


def conv4x4_s2_dgrad(dy: torch.Tensor, w: torch.Tensor,
                     hw: tuple[int, int]) -> torch.Tensor:
    """dy (N, H/2, W/2, Cout), the forward's OIHW w -> dx (N, H, W, Cin)."""
    what = "conv4x4_s2_dgrad"
    if not _build.on_cuda(dy, what):
        return conv4x4_s2_dgrad_plain(dy, w, hw)
    n, ho, wo, cout = dy.shape
    cin = w.shape[1]
    h, wd = hw
    if ((h, wd) != (2 * ho, 2 * wo) or tuple(w.shape) != (cout, cin, 4, 4)
            or not supported((n, h, wd, cin), cout, dy.dtype)):
        raise ValueError(f"{what}: unsupported {tuple(dy.shape)}, "
                         f"{tuple(w.shape)} -> {hw}")
    wt = dgrad_weights(w)
    _build.check_operands(what, dy.device, dy=dy, w=wt)
    dx = torch.empty((n, h, wd, cin), dtype=dy.dtype, device=dy.device)
    _build.raise_on(_library().asn_conv4x4_s2_dgrad(
        dy.data_ptr(), wt.data_ptr(), dx.data_ptr(), n, h, wd, cin, cout,
        _build.stream(dy)), what)
    conv4x4_s2_dgrad.launches += 1
    return dx


def wgrad_splits(n_pixels: int) -> int:
    return max(1, n_pixels // _WGRAD_PIXELS_PER_SPLIT)


def conv4x4_s2_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin), dy (N, H/2, W/2, Cout) -> dW (Cout, Cin, 4, 4) f32."""
    what = "conv4x4_s2_wgrad"
    if not _build.on_cuda(x, what):
        return conv4x4_s2_wgrad_plain(x, dy)
    _build.check_operands(what, x.device, x=x, dy=dy)
    n, h, wd, cin = x.shape
    cout = dy.shape[-1]
    if (tuple(dy.shape) != (n, h // 2, wd // 2, cout)
            or not supported(x.shape, cout, x.dtype)):
        raise ValueError(f"{what}: unsupported {tuple(x.shape)}, {tuple(dy.shape)}")
    splits = wgrad_splits(n * (h // 2) * (wd // 2))
    ws = torch.empty((splits, 16 * cin, cout), dtype=torch.float32, device=x.device)
    dk = torch.empty((16 * cin, cout), dtype=torch.float32, device=x.device)
    _build.raise_on(_library().asn_conv4x4_s2_wgrad(
        x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dk.data_ptr(),
        n, h, wd, cin, cout, splits, _build.stream(x)), what)
    conv4x4_s2_wgrad.launches += 1
    return dk.reshape(4, 4, cin, cout).permute(3, 2, 0, 1)


conv4x4_s2_fwd.launches = 0
conv4x4_s2_dgrad.launches = 0
conv4x4_s2_wgrad.launches = 0
