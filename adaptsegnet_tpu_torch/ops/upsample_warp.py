"""The Warper's sampler: upsample the logits and warp them by the flow, fused.

Counterpart of adaptsegnet_tpu/ops/pallas/upsample_warp.py::upsample_warp
(`:727`) with `planar=True, planar_out=True`, i.e.
warp_with_flow(upsample_logits(x, out_hw), flow) on a planar (N, 2, H, W)
flow, emitted as planar (N, C, H, W) logits for
ops/losses.py::cross_entropy_2d_planar:
  * `coords_from_flow` (`_coords_from_flow` `:698-724`) turns the raw flow
    into hi-res sample positions, clamp(tanh(flow) + identity grid, -1, 1)
    in pixel units, in f32 plain torch, so the tanh and clamp gradients come
    from autograd (JAX keeps them in XLA);
  * `UpsampleWarp`, a `torch.autograd.Function` with its boundary at
    (x, iy, ix) as JAX's custom VJP has: kernel 6 forward
    (ops/kernels/upsample_warp.py), dx by kernel 6's dx, and d(iy, ix) by
    its d-flow only when the coordinates need a gradient. In the train step
    the Warper runs under no_grad, so the flow is a constant and the d-flow
    kernel is never launched there (as XLA drops JAX's separate d-flow
    pallas_call, `:43-45`).
The identity grid is ops/sampling.py::linspace_f32's.
"""

from __future__ import annotations

import torch

from adaptsegnet_tpu_torch.ops.kernels import upsample_warp as k6
from adaptsegnet_tpu_torch.ops.sampling import linspace_f32


def coords_from_flow(flow: torch.Tensor, out_hw: tuple[int, int]):
    """Planar flow (N, 2, H, W), channel 0 displacing x (width) and channel 1
    y (height) -> (iy, ix) (N, H, W) f32 hi-res pixel positions."""
    hh, wh = out_hw
    gy = torch.from_numpy(linspace_f32(hh)).to(flow.device)
    gx = torch.from_numpy(linspace_f32(wh)).to(flow.device)
    f = torch.tanh(flow.float())
    sgx = torch.clamp(f[:, 0] + gx.view(1, 1, -1), -1.0, 1.0)
    sgy = torch.clamp(f[:, 1] + gy.view(1, -1, 1), -1.0, 1.0)
    ix = (sgx + 1.0) * 0.5 * (wh - 1)
    iy = (sgy + 1.0) * 0.5 * (hh - 1)
    return iy, ix


class UpsampleWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, iy, ix):
        """x (N, h, w, C) contiguous; iy, ix (N, H, W) f32 contiguous."""
        ctx.save_for_backward(x, iy, ix)
        return k6.upsample_warp_fwd(x, iy, ix)

    @staticmethod
    def backward(ctx, g):
        x, iy, ix = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need = ctx.needs_input_grad
        dx = k6.upsample_warp_dx(g, iy, ix, x.shape[1:3]) if need[0] else None
        diy = dix = None
        if need[1] or need[2]:
            diy, dix = k6.upsample_warp_dflow(x, g, iy, ix)
        return dx, diy, dix


def upsample_warp(x: torch.Tensor, flow: torch.Tensor,
                  out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """warp_with_flow(upsample_logits(x, out_hw), flow), fused and exact:
    x (N, h, w, C) raw logits, flow (N, 2, H, W) raw -> planar (N, C, H, W)
    in x's dtype. out_hw defaults to the flow's (H, W)."""
    if out_hw is None:
        out_hw = tuple(flow.shape[2:])
    iy, ix = coords_from_flow(flow, out_hw)
    return UpsampleWarp.apply(x.contiguous(), iy, ix)
