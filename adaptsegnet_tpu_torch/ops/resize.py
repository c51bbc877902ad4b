"""Bilinear resize with PyTorch `align_corners=True` semantics, as matmuls.

Counterpart of adaptsegnet_tpu/ops/resize.py (`_interp_matrix` :30,
`_interp_matrix_half_pixel` :59, `resize_bilinear_half_pixel` :106,
`resize_bilinear_align_corners` :113, `upsample_logits` :296). 1-D
align-corners (or half-pixel) interpolation along an axis is an
(out_len, in_len) matrix with at most two non-zeros per row, built from f64
source coordinates and stored as f32; a separable 2-D resize is two
matmuls, H first, then W.
`F.interpolate` is not used on the parity path: its f32 coordinate
arithmetic is not this matrix's, and the eval masks are held to it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_len: int, out_len: int) -> np.ndarray:
    """Dense (out_len, in_len) align_corners=True interpolation matrix.

    Row `o` holds the weights of output pixel `o`: src = o * (in_len - 1) /
    (out_len - 1); taps floor(src) and min(floor(src) + 1, in_len - 1) with
    weights (1 - frac, frac). Callers must not write to the result (cached).
    """
    m = np.zeros((out_len, in_len), dtype=np.float64)
    if out_len == 1:
        m[0, 0] = 1.0
        return m.astype(np.float32)
    if in_len == 1:
        m[:, 0] = 1.0
        return m.astype(np.float32)
    scale = (in_len - 1) / (out_len - 1)
    src = np.arange(out_len, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_len - 1)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = src - lo
    rows = np.arange(out_len)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, hi), frac)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _interp_matrix_half_pixel(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) align_corners=False (half-pixel) matrix: src =
    (o + 0.5) * in/out - 0.5 clamped to [0, in_len - 1], the default of the
    nn.Upsample inside the reference Warper's decoder. Cached; read only."""
    m = np.zeros((out_len, in_len), dtype=np.float64)
    src = np.clip((np.arange(out_len, dtype=np.float64) + 0.5)
                  * (in_len / out_len) - 0.5, 0.0, in_len - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = src - lo
    rows = np.arange(out_len)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, hi), frac)
    return m.astype(np.float32)


def _separable_resize(x: torch.Tensor, out_hw: tuple[int, int], matrix_fn,
                      exact: bool) -> torch.Tensor:
    """NHWC resize as two matmuls, H first, then W. exact=True: in f32 (TF32
    off on the parity path, see ops/precision.py), cast back to x.dtype;
    exact=False: in x.dtype with x.dtype matrices (the bf16 path)."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    ctype = torch.float32 if exact else x.dtype
    mh = torch.from_numpy(matrix_fn(h, oh)).to(x.device, ctype)
    mw = torch.from_numpy(matrix_fn(w, ow)).to(x.device, ctype)
    y = torch.einsum("oh,nhwc->nowc", mh, x.to(ctype))
    y = torch.einsum("pw,nhwc->nhpc", mw, y)
    return y.to(x.dtype)


def resize_bilinear_half_pixel(
    x: torch.Tensor, out_hw: tuple[int, int], exact: bool = True
) -> torch.Tensor:
    """Resize NHWC `x` with align_corners=False (half-pixel) bilinear."""
    return _separable_resize(x, out_hw, _interp_matrix_half_pixel, exact)


def resize_bilinear_align_corners(
    x: torch.Tensor, out_hw: tuple[int, int], exact: bool = True
) -> torch.Tensor:
    """Resize NHWC `x` to `out_hw` with align_corners=True bilinear."""
    return _separable_resize(x, out_hw, _interp_matrix, exact)


def upsample_logits(
    logits: torch.Tensor, out_hw: tuple[int, int], exact: bool = True
) -> torch.Tensor:
    """Upsample segmentation logits (N, h, w, C) to (N, H, W, C): the
    reference's `interp` module (evaluate_cityscapes.py:153). Training runs
    bf16 models with exact=False, in the compute dtype
    (adaptsegnet_tpu/train/steps.py:99-110)."""
    return resize_bilinear_align_corners(logits, out_hw, exact=exact)


def upsample_softmax_planar(
    logits: torch.Tensor, out_hw: tuple[int, int]
) -> torch.Tensor:
    """The discriminator input: softmax over classes of the align-corners
    upsample of raw (N, h, w, C) logits, as a planar (N, C, H, W) map.

    Counterpart of adaptsegnet_tpu/ops/resize.py::upsample_softmax_s2d_planar
    (`:255-293`), which emits the four stride-2 parity phases of the padded
    map for the TPU kernel; the port's conv1 kernel reads the dense map and
    pads on load (ops/kernels/conv4x4_patch.py), so the values here are the
    same map without the phase split and the zero pad. The resize runs in
    the logits' dtype with f32 matrices for f32 (exact) and in-dtype for
    bf16, as the JAX producer does."""
    oh, ow = out_hw
    n, h, w, c = logits.shape
    x = logits.permute(0, 3, 1, 2)  # tiny low-res tensor
    mh = torch.from_numpy(_interp_matrix(h, oh)).to(x.device, x.dtype)
    mw = torch.from_numpy(_interp_matrix(w, ow)).to(x.device, x.dtype)
    y = torch.einsum("oh,nchw->ncow", mh, x)
    y = torch.einsum("pw,ncow->ncop", mw, y)
    return torch.softmax(y, dim=1)
