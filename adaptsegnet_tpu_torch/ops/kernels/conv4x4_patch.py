"""The discriminator's conv1 over the planar softmax map: kernel 4.

Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/conv4x4_patch.py
(`conv4x4_s2_phases_planar`, forward, wgrad and dgrad): torch
Conv2d(C, 64, k=4, s=2, p=1) with C = 19, bf16 in, f32 accumulation. The
TPU version takes the four stride-2 parity phases of the padded map, a
layout made for the TPU's lanes; the port's producer
(ops/resize.py::upsample_softmax_planar) emits the dense (N, C, H, W) map,
and the kernels read it with the conv padding applied on load. The CUDA
source is csrc/conv4x4_patch.cu (on csrc/igemm_sm90.cuh's pieces); its note
gives the design. Bytes bound every direction (~36.7 MB, 10.97 us at
3.35 TB/s at 512x1024).

Three wrappers, each with its own launch count:
  conv4x4_patch_fwd(x, w, b)   (N, C, H, W) planar -> (N, H/2, W/2, 64) NHWC
                               bf16, f32 bias added before the one rounding
                               (weights: OIHW reshaped, K-major, no copy);
  conv4x4_patch_dgrad(dy, w, hw)  -> dx (N, C, H, W) planar bf16 (the
                               parity-class weights of
                               conv4x4_s2.dgrad_weights, one copy);
  conv4x4_patch_wgrad(x, dy)   -> dW (64, C, 4, 4) f32 (the pixels split by
                               `wgrad_plan`, partials summed in order).
A CPU tensor takes the plain PyTorch version (f32 convolutions of the bf16
values); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from adaptsegnet_tpu_torch.ops.kernels import _build
from adaptsegnet_tpu_torch.ops.kernels import conv4x4_s2 as k5

COUT = 64        # the kernel's output channels (the discriminator's ndf)
MAX_C = 20       # 16 * C must fit the kernel's five K steps of 64
# The wgrad's K step: one row segment of 64 output pixels; the card's SMs
# (H100 SXM), one wave of the wgrad's blocks.
WGRAD_PX, SMS = 64, 132


def supported(x_shape, cout: int, dtype: torch.dtype) -> bool:
    n, c, h, w = x_shape
    return (dtype == torch.bfloat16 and c <= MAX_C and cout == COUT
            and h % 2 == 0 and w % 2 == 0)


# ------------------------------------------------------------ plain versions


def conv4x4_patch_fwd_plain(x, w, b):
    y = F.conv2d(x.float(), w.float(), None if b is None else b.float(), 2, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv4x4_patch_dgrad_plain(dy, w, hw):
    n = dy.shape[0]
    dx = conv2d_input((n, w.shape[1]) + tuple(hw), w.float(),
                      dy.permute(0, 3, 1, 2).float(), 2, 1)
    return dx.to(dy.dtype).contiguous()


def conv4x4_patch_wgrad_plain(x, dy):
    return conv2d_weight(x.float(), (dy.shape[-1], x.shape[1], 4, 4),
                         dy.permute(0, 3, 1, 2).float(), 2, 1)


# ------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("conv4x4_patch")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.asn_conv4x4_patch_fwd.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.asn_conv4x4_patch_wgrad.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.asn_conv4x4_patch_dgrad.argtypes = [p] * 3 + [i] * 4 + [p]
    for fn in (lib.asn_conv4x4_patch_fwd, lib.asn_conv4x4_patch_wgrad,
               lib.asn_conv4x4_patch_dgrad):
        fn.restype = i
    return lib


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, C, 4, 4) -> the forward's K-major (64, 16*C), column
    c*16 + ky*4 + kx: a view of a contiguous w (the kernel's TMA zero-fills
    K up to 320)."""
    return w.reshape(w.shape[0], -1)


def wgrad_plan(n: int, h: int, w: int) -> tuple[int, int]:
    """(splits, per) of the wgrad's launch at input (n, C, h, w): its K
    steps are the row segments of WGRAD_PX output pixels (the last of a
    row masked), split into the most ranges one wave of blocks holds (each
    block covers all 16*C x 64 of dW); per is the steps in each range,
    every step in exactly one range, none empty."""
    steps = n * (h // 2) * -(-(w // 2) // WGRAD_PX)
    per = -(-steps // min(steps, SMS))
    return -(-steps // per), per


def conv4x4_patch_fwd(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None) -> torch.Tensor:
    what = "conv4x4_patch_fwd"
    if not _build.on_cuda(x, what):
        return conv4x4_patch_fwd_plain(x, w, b)
    n, c, h, wd = x.shape
    if tuple(w.shape) != (COUT, c, 4, 4) or not supported(x.shape, COUT, x.dtype):
        raise ValueError(f"{what}: unsupported {tuple(x.shape)}, {tuple(w.shape)}")
    wt = kmajor_weights(w)
    _build.check_operands(what, x.device, x=x, w=wt)
    bias = (torch.zeros(COUT, device=x.device) if b is None
            else b.to(x.device, torch.float32).contiguous())
    out = torch.empty((n, h // 2, wd // 2, COUT), dtype=x.dtype, device=x.device)
    _build.raise_on(_library().asn_conv4x4_patch_fwd(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, c, h, wd, _build.stream(x)), what)
    conv4x4_patch_fwd.launches += 1
    return out


def conv4x4_patch_dgrad(dy: torch.Tensor, w: torch.Tensor,
                        hw: tuple[int, int]) -> torch.Tensor:
    """dy (N, H/2, W/2, 64) NHWC -> dx (N, C, H, W) planar."""
    what = "conv4x4_patch_dgrad"
    if not _build.on_cuda(dy, what):
        return conv4x4_patch_dgrad_plain(dy, w, hw)
    n, ho, wo, cout = dy.shape
    c = w.shape[1]
    h, wd = hw
    if ((h, wd) != (2 * ho, 2 * wo) or tuple(w.shape) != (COUT, c, 4, 4)
            or not supported((n, c, h, wd), cout, dy.dtype)):
        raise ValueError(f"{what}: unsupported {tuple(dy.shape)}, "
                         f"{tuple(w.shape)} -> {hw}")
    wt = k5.dgrad_weights(w)
    _build.check_operands(what, dy.device, dy=dy, w=wt)
    dx = torch.empty((n, c, h, wd), dtype=dy.dtype, device=dy.device)
    _build.raise_on(_library().asn_conv4x4_patch_dgrad(
        dy.data_ptr(), wt.data_ptr(), dx.data_ptr(), n, c, h, wd,
        _build.stream(dy)), what)
    conv4x4_patch_dgrad.launches += 1
    return dx


def conv4x4_patch_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W) planar, dy (N, H/2, W/2, 64) -> dW (64, C, 4, 4) f32."""
    what = "conv4x4_patch_wgrad"
    if not _build.on_cuda(x, what):
        return conv4x4_patch_wgrad_plain(x, dy)
    _build.check_operands(what, x.device, x=x, dy=dy)
    n, c, h, wd = x.shape
    if (tuple(dy.shape) != (n, h // 2, wd // 2, COUT)
            or not supported(x.shape, COUT, x.dtype)):
        raise ValueError(f"{what}: unsupported {tuple(x.shape)}, {tuple(dy.shape)}")
    splits, per = wgrad_plan(n, h, wd)
    ws = (torch.empty((splits, 16 * c, COUT), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    dk = torch.empty((16 * c, COUT), dtype=torch.float32, device=x.device)
    _build.raise_on(_library().asn_conv4x4_patch_wgrad(
        x.data_ptr(), dy.data_ptr(), None if ws is None else ws.data_ptr(),
        dk.data_ptr(), n, c, h, wd, splits, per, _build.stream(x)), what)
    conv4x4_patch_wgrad.launches += 1
    return dk.reshape(c, 4, 4, COUT).permute(3, 0, 1, 2)


conv4x4_patch_fwd.launches = 0
conv4x4_patch_dgrad.launches = 0
conv4x4_patch_wgrad.launches = 0
