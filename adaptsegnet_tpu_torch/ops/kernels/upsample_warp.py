"""Fused align-corners upsample + flow warp: kernel 6, forward, dx and d-flow.

Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/upsample_warp.py
(`upsample_warp` -> `_sample_upsampled`, six pallas_calls in two layout
families that compute the same three functions). The CUDA source is
csrc/upsample_warp.cu; its note gives the function and the design. For
output pixel p with hi-res sample position (iy, ix):

    out[c, p] = sum_{ly, lx} VY[p, ly] VX[p, lx] x[ly, lx, c]

where VY's row holds the align-corners upsample weights of the two hi-res
rows floor(iy) and floor(iy) + 1 lerped by iy's fraction (`_hats` `:125`),
at most three non-zeros for an upsample. Three wrappers, each with its own
launch count:
  upsample_warp_fwd(x, iy, ix)       x (N, h, w, C), iy/ix (N, H, W) f32 ->
                                     planar (N, C, H, W) in x's dtype;
  upsample_warp_dx(g, iy, ix, hw)    planar cotangent -> dx (N, h, w, C) in
                                     g's dtype;
  upsample_warp_dflow(x, g, iy, ix)  -> (diy, dix) (N, H, W) f32.
The forward and dx work on tiles of output pixels (`tile_plan`), each with
a window of lo-res cells in shared memory: the forward gathers from it; dx
adds into it in fixed point (the card adds no f32 in shared memory
natively) and then adds its non-zero cells to an f64 buffer in device
memory, which a second kernel rounds into dx. A product w g goes to the
window as two int32 words, in units of 2^-fix and 2^-2fix of the tile's
largest |g| rounded up to a power of two (`fix_bits`: 21 at the train
shape, where the busiest window cell takes ~400 products), when they hold
it within 2^-24 of its value; a smaller product goes to the f64 buffer as
the f32 product. So each cell of dx is within 2^-24 of the sum of its
products' magnitudes of their exact sum, before its own rounding, however g
spreads; only the speed depends on the spread. A pixel whose cells leave
the window (a flow that moves it more than the margin, a clamped sample)
reads or adds in device memory instead, so any flow gives the same
function. The f64 adds come in no fixed order, so dx is not bit-reproducible
in general. Every weight stays f32 and each output is rounded once (the
Pallas kernel rounds the x-direction weights to bf16 for the MXU in bf16;
that difference is intended, ROADMAP.md §3).

The plain PyTorch version `upsample_warp_plain` is the same function as a
differentiable 3x3-tap gather in f32; its autograd gives dx and d(iy, ix)
(the derivative of the lerp is the tap difference, as in `_dhats`). A CPU
tensor takes it; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from adaptsegnet_tpu_torch.ops.kernels import _build


def scales(in_hw: tuple[int, int], out_hw: tuple[int, int]) -> tuple[float, float]:
    """(s_y, s_x) = (h-1)/(H-1), (w-1)/(W-1); 0 for a length-1 output."""
    (h, w), (oh, ow) = in_hw, out_hw
    return ((h - 1) / (oh - 1) if oh > 1 else 0.0,
            (w - 1) / (ow - 1) if ow > 1 else 0.0)


TILE_W = 256        # output columns of a tile: dx's 64 runs of 4 pixels
MARGIN = 4          # lo-res cells of window beyond the identity grid's reach
# Most shared memory dx's window may take: per cell two int32 sums per
# channel (C padded to even) and one int32 count. With the list of a tile's
# pixels (16 KB) it stays within the 227 KB of one H100 block.
WINDOW_BYTES = 192 * 1024
# About one 1024-thread block on each of the H100's 132 SMs. A constant, not
# the device's count: the kernels build for sm_90a only, and the plan stays
# a pure function of the shape.
TARGET_TILES = 128


@functools.lru_cache(maxsize=64)
def tile_plan(n: int, in_hw: tuple[int, int], out_hw: tuple[int, int],
              c: int) -> tuple[int, int, int, int, int]:
    """(th, tw, m, wh, ww): tiles of th x tw output pixels, and a window of
    wh x ww lo-res cells (all C channels, padded to an even count) around
    the cells that the tile's identity grid reaches with its 3x3 taps, m
    cells beyond them on each side.

    tw is TILE_W (or the width rounded up to a multiple of 8); th is the
    tallest of 16, 8, 4, 2 that still gives TARGET_TILES tiles (else 1).
    The identity bases of th consecutive rows span floor((th - 1) s) + 1
    cells at most, the taps add 2, f32 rounding of r * s at most 1: so
    wh = floor((th - 1) s_y) + 5 + 2 m. The margin shrinks until dx's window
    (`window_bytes`) fits in WINDOW_BYTES; where none fits, the window is
    empty and every pixel takes the device-memory path."""
    (h, w), (oh, ow) = in_hw, out_hw
    sy, sx = scales(in_hw, out_hw)
    tw = min(TILE_W, -(-ow // 8) * 8)
    tiles_x = -(-ow // tw)
    th = next((t for t in (16, 8, 4, 2)
               if n * -(-oh // t) * tiles_x >= TARGET_TILES), 1)
    for m in range(MARGIN, -1, -1):
        wh = int(np.floor((th - 1) * sy)) + 5 + 2 * m
        ww = int(np.floor((tw - 1) * sx)) + 5 + 2 * m
        if window_bytes(wh, ww, c) <= WINDOW_BYTES:
            return th, tw, m, wh, ww
    return th, tw, 0, 0, 0


def window_bytes(wh: int, ww: int, c: int) -> int:
    """dx's shared window of wh x ww cells: two int32 sums per channel (C
    padded to even) and one int32 count per cell."""
    return wh * ww * (2 * (c + c % 2) + 1) * 4


def fix_bits(n: int) -> int:
    """csrc/upsample_warp.cu::fix_bits: dx's fixed-point bits below a tile's
    largest |g| when its busiest window cell takes n products (one per
    in-window pixel whose 3x3 holds it), each at most 2^fix units: with
    fix = 30 - ceil(log2(n)) (at most 22) no int32 sum passes 2^30."""
    return min(22, 30 - (max(n, 1) - 1).bit_length())


def keep_units(fix: int) -> int:
    """csrc/upsample_warp.cu::add_product: the least |hi| (in units of
    2^-fix of the tile's scale) that dx's window takes; hi + lo 2^-fix is
    then within 2^-26 + 2^-(fix + 1) units of the product, less than 2^-24
    of it. A smaller product goes to device memory."""
    return 1 << (24 - fix)


# ------------------------------------------------------------ plain version


def _axis_taps(i: torch.Tensor, s: float, n_lo: int):
    """The three lo-res taps of one axis for coordinates i (f32): clamped
    indices and weights (..., 3); out-of-range taps weigh 0. The weights are
    differentiable in i (floor carries no gradient)."""
    s = torch.tensor(s, dtype=torch.float32)
    r0 = torch.floor(i)
    w1 = (i - r0).unsqueeze(-1)
    p0 = (r0 * s).unsqueeze(-1)
    p1 = ((r0 + 1.0) * s).unsqueeze(-1)
    lo = torch.floor(p0) + torch.arange(3, dtype=torch.float32, device=i.device)
    h0 = torch.clamp(1.0 - torch.abs(p0 - lo), min=0.0)
    h1 = torch.clamp(1.0 - torch.abs(p1 - lo), min=0.0)
    ok = (lo >= 0) & (lo < n_lo)
    v = torch.where(ok, h0 * (1.0 - w1) + h1 * w1, torch.zeros_like(h0))
    return lo.clamp(0, n_lo - 1).long(), v


def upsample_warp_plain(x: torch.Tensor, iy: torch.Tensor,
                        ix: torch.Tensor) -> torch.Tensor:
    """The kernel's function in f32: (N, h, w, C), (N, H, W) x2 -> planar
    (N, C, H, W) f32, differentiable in x, iy and ix. Memory ~ N*H*W*9*C
    f32 (0.36 GB at the train shape)."""
    n, h, w, c = x.shape
    _, oh, ow = iy.shape
    sy, sx = scales((h, w), (oh, ow))
    iy_t, vy = _axis_taps(iy.float().reshape(n, -1), sy, h)
    ix_t, vx = _axis_taps(ix.float().reshape(n, -1), sx, w)
    cells = (iy_t.unsqueeze(-1) * w + ix_t.unsqueeze(-2)).reshape(n, -1)
    xg = x.float().reshape(n, h * w, c).gather(
        1, cells.unsqueeze(-1).expand(-1, -1, c)).reshape(n, -1, 3, 3, c)
    wt = vy.unsqueeze(-1) * vx.unsqueeze(-2)                 # (n, P, 3, 3)
    out = (wt.unsqueeze(-1) * xg).sum(dim=(2, 3))            # (n, P, C)
    return out.transpose(1, 2).reshape(n, c, oh, ow)


def upsample_warp_fwd_plain(x, iy, ix):
    return upsample_warp_plain(x, iy, ix).to(x.dtype)


def upsample_warp_dx_plain(g, iy, ix, hw):
    n, c = g.shape[:2]
    with torch.enable_grad():
        x = torch.zeros((n, *hw, c), device=g.device, requires_grad=True)
        out = upsample_warp_plain(x, iy.detach(), ix.detach())
        (dx,) = torch.autograd.grad(out, x, g.float())
    return dx.to(g.dtype)


def upsample_warp_dflow_plain(x, g, iy, ix):
    with torch.enable_grad():
        iy = iy.detach().float().requires_grad_(True)
        ix = ix.detach().float().requires_grad_(True)
        out = upsample_warp_plain(x.detach(), iy, ix)
        diy, dix = torch.autograd.grad(out, (iy, ix), g.float())
    return diy, dix


# ------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("upsample_warp")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 7 + [f, f]  # is_bf16, n, h, w, c, oh, ow, sy, sx
    lib.asn_upsample_warp_fwd.argtypes = [p] * 4 + tail + [i] * 5 + [p]
    lib.asn_upsample_warp_dx.argtypes = [p] * 5 + tail + [i] * 5 + [p]
    lib.asn_upsample_warp_dflow.argtypes = [p] * 6 + tail + [p]
    for fn in (lib.asn_upsample_warp_fwd, lib.asn_upsample_warp_dx,
               lib.asn_upsample_warp_dflow):
        fn.restype = i
    return lib


def _check(what: str, device: torch.device, dtype: torch.dtype, n: int,
           in_hw: tuple[int, int], out_hw: tuple[int, int], c: int,
           data: dict, coords: dict) -> None:
    """Operands on one device and contiguous; data in x's dtype (f32 or
    bf16), coordinates f32 (N, H, W); an upsample (s <= 1)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype must be float32 or bfloat16, got {dtype}")
    (h, w), (oh, ow) = in_hw, out_hw
    if min(n, h, w, c, oh, ow) < 1 or h > oh or w > ow:
        raise ValueError(f"{what}: unsupported {(n, h, w, c)} -> {out_hw} "
                         "(the kernel takes an upsample)")
    for name, t in {**data, **coords}.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {device}, "
                             f"got {t.device} strides {t.stride()}")
    for name, t in data.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
    for name, t in coords.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (n, oh, ow):
            raise ValueError(f"{what}: {name} must be f32 {(n, oh, ow)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _tail(dtype, n, h, w, c, oh, ow):
    sy, sx = scales((h, w), (oh, ow))
    return (int(dtype == torch.bfloat16), n, h, w, c, oh, ow, sy, sx)


def upsample_warp_fwd(x: torch.Tensor, iy: torch.Tensor,
                      ix: torch.Tensor) -> torch.Tensor:
    """x (N, h, w, C) sampled at the hi-res positions (iy, ix) of its
    align-corners upsample -> planar (N, C, H, W) in x's dtype."""
    what = "upsample_warp_fwd"
    if not _build.on_cuda(x, what):
        return upsample_warp_fwd_plain(x, iy, ix)
    n, h, w, c = x.shape
    oh, ow = iy.shape[1:]
    _check(what, x.device, x.dtype, n, (h, w), (oh, ow), c, {"x": x},
           {"iy": iy, "ix": ix})
    out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    _build.raise_on(_library().asn_upsample_warp_fwd(
        x.data_ptr(), iy.data_ptr(), ix.data_ptr(), out.data_ptr(),
        *_tail(x.dtype, n, h, w, c, oh, ow),
        *tile_plan(n, (h, w), (oh, ow), c), _build.stream(x)), what)
    upsample_warp_fwd.launches += 1
    return out


def upsample_warp_dx(g: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                     hw: tuple[int, int]) -> torch.Tensor:
    """Planar cotangent g (N, C, H, W) -> dx (N, h, w, C) in g's dtype. The
    kernel sums into an f64 (N, h, w, C) buffer that starts at zero, and a
    second kernel rounds it once into dx. Each cell is within 2^-24 of the
    sum of its products' magnitudes of their exact sum, before that
    rounding; not bit-reproducible in general (f64 adds in no fixed
    order)."""
    what = "upsample_warp_dx"
    hw = (int(hw[0]), int(hw[1]))
    if not _build.on_cuda(g, what):
        return upsample_warp_dx_plain(g, iy, ix, hw)
    n, c, oh, ow = g.shape
    h, w = hw
    _check(what, g.device, g.dtype, n, hw, (oh, ow), c, {"g": g},
           {"iy": iy, "ix": ix})
    acc = torch.zeros((n, h, w, c), dtype=torch.float64, device=g.device)
    dx = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
    _build.raise_on(_library().asn_upsample_warp_dx(
        g.data_ptr(), iy.data_ptr(), ix.data_ptr(), acc.data_ptr(),
        dx.data_ptr(), *_tail(g.dtype, n, h, w, c, oh, ow),
        *tile_plan(n, hw, (oh, ow), c), _build.stream(g)), what)
    upsample_warp_dx.launches += 1
    return dx


def upsample_warp_dflow(x: torch.Tensor, g: torch.Tensor, iy: torch.Tensor,
                        ix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, h, w, C), planar cotangent g (N, C, H, W) -> (diy, dix), the
    f32 gradients of <out, g> with respect to the sample positions."""
    what = "upsample_warp_dflow"
    if not _build.on_cuda(x, what):
        return upsample_warp_dflow_plain(x, g, iy, ix)
    n, h, w, c = x.shape
    oh, ow = iy.shape[1:]
    _check(what, x.device, x.dtype, n, (h, w), (oh, ow), c, {"x": x, "g": g},
           {"iy": iy, "ix": ix})
    if tuple(g.shape) != (n, c, oh, ow):
        raise ValueError(f"{what}: g {tuple(g.shape)}, expected {(n, c, oh, ow)}")
    diy = torch.empty((n, oh, ow), dtype=torch.float32, device=x.device)
    dix = torch.empty_like(diy)
    _build.raise_on(_library().asn_upsample_warp_dflow(
        x.data_ptr(), g.data_ptr(), iy.data_ptr(), ix.data_ptr(),
        diy.data_ptr(), dix.data_ptr(),
        *_tail(x.dtype, n, h, w, c, oh, ow), _build.stream(x)), what)
    upsample_warp_dflow.launches += 1
    return diy, dix


upsample_warp_fwd.launches = 0
upsample_warp_dx.launches = 0
upsample_warp_dflow.launches = 0
