"""Bilinear grid sampling and the unfused flow warp (torch-0.4 grid_sample).

Counterpart of adaptsegnet_tpu/ops/sampling.py (`grid_sample_bilinear`
:21, `make_identity_grid` :68, `warp_with_flow` :80): the reference's
sampler clamp(tanh(flow) + identity grid, -1, 1) and an align_corners=True,
zero-padded bilinear grid_sample (reference model/deeplab_multi.py:238-255),
as four corner gathers and a lerp on NHWC tensors. The train path runs the
fused kernel 6 instead (ops/upsample_warp.py); this composition, with
ops/resize.py::upsample_logits before it, is the function that kernel is
held against, and the semantics of its library-call yardstick.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def linspace_f32(n: int) -> np.ndarray:
    """linspace(-1, 1, n) in f64 rounded to f32 (jnp.linspace's f32
    arithmetic differs from it by at most one ulp in some elements)."""
    return np.linspace(-1.0, 1.0, n).astype(np.float32)


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample NHWC `x` at `grid` (N, Ho, Wo, 2) of (gx, gy) in [-1, 1]:
    ix = (gx + 1) / 2 * (W - 1), iy likewise; out-of-range corner taps
    contribute zero. Returns (N, Ho, Wo, C) in x's dtype."""
    n, h, w, c = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    ix = (gx + 1.0) * 0.5 * (w - 1)
    iy = (gy + 1.0) * 0.5 * (h - 1)
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - ix0, iy - iy0
    src = x.reshape(n, h * w, c).float()

    def tap(yf, xf, wy, wx):
        valid = (xf >= 0) & (xf <= w - 1) & (yf >= 0) & (yf <= h - 1)
        flat = (yf.clamp(0, h - 1) * w + xf.clamp(0, w - 1)).long()
        vals = src.gather(1, flat.reshape(n, -1, 1).expand(-1, -1, c))
        weight = (wy * wx * valid.float()).reshape(n, -1, 1)
        return (vals * weight).reshape(*flat.shape, c)

    out = (tap(iy0, ix0, 1.0 - wy1, 1.0 - wx1) + tap(iy0, ix0 + 1, 1.0 - wy1, wx1)
           + tap(iy0 + 1, ix0, wy1, 1.0 - wx1) + tap(iy0 + 1, ix0 + 1, wy1, wx1))
    return out.to(x.dtype)


def make_identity_grid(h: int, w: int, device=None) -> torch.Tensor:
    """The reference's [-1, 1] identity mesh (h, w, 2) in (gx, gy) order."""
    gy = torch.from_numpy(linspace_f32(h)).to(device)
    gx = torch.from_numpy(linspace_f32(w)).to(device)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    return torch.stack([gxx, gyy], dim=-1)


def warp_with_flow(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp NHWC `x` by a raw flow (N, H, W, 2): flow[..., 0] displaces x
    (width), flow[..., 1] y (height)."""
    _, h, w, _ = flow.shape
    grid = torch.tanh(flow.float()) + make_identity_grid(h, w, flow.device)
    return grid_sample_bilinear(x, torch.clamp(grid, -1.0, 1.0))
