"""The discriminator's conv1 over the planar softmax map: kernel 4.

Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/conv4x4_patch.py
(`conv4x4_s2_phases_planar`, forward, wgrad and dgrad): torch
Conv2d(C, 64, k=4, s=2, p=1) with C = 19, bf16 in, f32 accumulation. The
TPU version takes the four stride-2 parity phases of the padded map, a
layout made for the TPU's lanes; the port's producer
(ops/resize.py::upsample_softmax_planar) emits the dense (N, C, H, W) map,
and the kernels read it with the conv padding applied on load. The CUDA
source is csrc/conv4x4_patch.cu; its note gives the design.

Three wrappers, each with its own launch count:
  conv4x4_patch_fwd(x, w, b)   (N, C, H, W) planar -> (N, H/2, W/2, 64) NHWC
                               bf16, f32 bias added before the one rounding;
  conv4x4_patch_dgrad(dy, w, hw)  -> dx (N, C, H, W) planar bf16;
  conv4x4_patch_wgrad(x, dy)   -> dW (64, C, 4, 4) f32 (split-K, partials
                               summed in order).
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

COUT = 64        # the kernel's output channels (the discriminator's ndf)
MAX_C = 20       # 16 * C must fit the kernel's 320 patch columns
_KP = 320
_WGRAD_SPLITS = 128


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
    lib.asn_conv4x4_patch_wgrad.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.asn_conv4x4_patch_dgrad.argtypes = [p] * 3 + [i] * 4 + [p]
    for fn in (lib.asn_conv4x4_patch_fwd, lib.asn_conv4x4_patch_wgrad,
               lib.asn_conv4x4_patch_dgrad):
        fn.restype = i
    return lib


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, C, 4, 4) -> (320, 64): row c*16 + ky*4 + kx, zero rows
    past 16*C."""
    cout, c = w.shape[:2]
    wp = w.permute(1, 2, 3, 0).reshape(16 * c, cout)
    return F.pad(wp, (0, 0, 0, _KP - 16 * c)).contiguous()


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, C, 4, 4) -> (2, 512, 32): for row parity py, row
    (a*4 + kx)*64 + co holds W[co, :, 1 - py + 2a, kx]; columns past C
    zero. With ky = 2a + ry the parity's taps are those with ry = 1 - py."""
    cout, c = w.shape[:2]
    w5 = w.reshape(cout, c, 2, 2, 4)               # (co, c, a, ry, kx)
    w5 = w5.permute(3, 2, 4, 0, 1).flip(0)         # (py, a, kx, co, c)
    return F.pad(w5.reshape(2, 8 * cout, c), (0, 32 - c)).contiguous()


def conv4x4_patch_fwd(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None) -> torch.Tensor:
    what = "conv4x4_patch_fwd"
    if not _build.on_cuda(x, what):
        return conv4x4_patch_fwd_plain(x, w, b)
    n, c, h, wd = x.shape
    if tuple(w.shape) != (COUT, c, 4, 4) or not supported(x.shape, COUT, x.dtype):
        raise ValueError(f"{what}: unsupported {tuple(x.shape)}, {tuple(w.shape)}")
    wpk = pack_weights(w)
    _build.check_operands(what, x.device, x=x, w=wpk)
    bias = (torch.zeros(COUT, device=x.device) if b is None
            else b.to(x.device, torch.float32).contiguous())
    out = torch.empty((n, h // 2, wd // 2, COUT), dtype=x.dtype, device=x.device)
    _build.raise_on(_library().asn_conv4x4_patch_fwd(
        x.data_ptr(), wpk.data_ptr(), bias.data_ptr(), out.data_ptr(),
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
    wpy = dgrad_weights(w)
    _build.check_operands(what, dy.device, dy=dy, w=wpy)
    dx = torch.empty((n, c, h, wd), dtype=dy.dtype, device=dy.device)
    _build.raise_on(_library().asn_conv4x4_patch_dgrad(
        dy.data_ptr(), wpy.data_ptr(), dx.data_ptr(), n, c, h, wd,
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
    ws = torch.empty((_WGRAD_SPLITS, _KP, COUT), dtype=torch.float32,
                     device=x.device)
    dk = torch.empty((_KP, COUT), dtype=torch.float32, device=x.device)
    _build.raise_on(_library().asn_conv4x4_patch_wgrad(
        x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dk.data_ptr(),
        n, c, h, wd, _WGRAD_SPLITS, _build.stream(x)), what)
    conv4x4_patch_wgrad.launches += 1
    return dk[:16 * c].reshape(c, 4, 4, COUT).permute(3, 0, 1, 2)


conv4x4_patch_fwd.launches = 0
conv4x4_patch_dgrad.launches = 0
conv4x4_patch_wgrad.launches = 0
