"""Fused bilinear-upsample + channel-argmax: the eval tail as one CUDA kernel.

Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/upsample_argmax.py
(`upsample_argmax`): (N, h, w, C) NHWC logits -> (N, H, W) uint8, the
first-index argmax of the align_corners=True bilinear upsample. The kernel
is csrc/upsample_argmax.cu (its note gives the design). On the H100 it is
bound by operations: about 1.7e8 f32 lerp and compare operations at the eval
shape (64x128x19 -> 1024x2048) against ~2.4 MB of traffic.

`upsample_argmax` takes the plain PyTorch version below only for a tensor
on the CPU; a CUDA tensor launches the kernel or raises. The plain version
is the kernel's function: upsample with ops/resize.py's matrices in f32
(for bf16 input too), then argmax. `upsample_argmax.launches` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from adaptsegnet_tpu_torch.ops.kernels import _build
from adaptsegnet_tpu_torch.ops.resize import resize_bilinear_align_corners

_MAX_SMEM = 232_448  # bytes of shared memory one H100 block can use
_MAX_GRID_YZ = 65_535


def axis_tables(in_len: int, out_len: int):
    """Per-output-index taps and weights (i0, i1, w0, w1) of one axis.

    The formula of ops/resize.py::_interp_matrix (f64 source coordinates,
    f32 weights), so that w0/w1 equal the matrix's non-zeros bit for bit.
    """
    if out_len == 1 or in_len == 1:
        zeros = np.zeros(out_len, np.int32)
        return (zeros, zeros.copy(), np.ones(out_len, np.float32),
                np.zeros(out_len, np.float32))
    src = np.arange(out_len, dtype=np.float64) * ((in_len - 1) / (out_len - 1))
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_len - 1)
    i1 = np.minimum(i0 + 1, in_len - 1)
    frac = src - i0
    return (i0.astype(np.int32), i1.astype(np.int32),
            (1.0 - frac).astype(np.float32), frac.astype(np.float32))


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, oh: int, w: int, ow: int, device: torch.device):
    """The kernel's (int32 taps, f32 weights), rows then columns, on device."""
    r0, r1, rw0, rw1 = axis_tables(h, oh)
    c0, c1, cw0, cw1 = axis_tables(w, ow)
    idx = torch.from_numpy(np.concatenate([r0, r1, c0, c1])).to(device)
    wt = torch.from_numpy(np.concatenate([rw0, rw1, cw0, cw1])).to(device)
    return idx, wt


def upsample_argmax_plain(logits: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """The plain PyTorch version: f32 matrix upsample, then argmax."""
    up = resize_bilinear_align_corners(logits.float(), out_hw, exact=True)
    return up.argmax(dim=-1).to(torch.uint8)


def _check(logits: torch.Tensor, out_hw: tuple[int, int]) -> None:
    if logits.dim() != 4:
        raise ValueError(f"logits must be (N, h, w, C), got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous NHWC")
    n, h, w, c = logits.shape
    oh, ow = out_hw
    if not 1 <= c <= 255:
        raise ValueError(f"channel count {c} does not fit uint8 (1..255)")
    if min(n, h, w, oh, ow) < 1 or max(n, oh) > _MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {tuple(logits.shape)} -> {out_hw}")
    if w * c * 4 > _MAX_SMEM:
        raise ValueError(f"w * C = {w * c} exceeds the kernel's shared memory")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("upsample_argmax")
    fn = lib.asn_upsample_argmax
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def upsample_argmax(logits: torch.Tensor,
                    out_hw: tuple[int, int]) -> torch.Tensor:
    """(N, h, w, C) logits -> (N, H, W) uint8 argmax of the align-corners
    bilinear upsample to out_hw; the first maximal channel wins."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if logits.device.type == "cpu":
        return upsample_argmax_plain(logits, out_hw)
    if logits.device.type != "cuda":
        raise ValueError(f"no upsample_argmax for device {logits.device}")
    _check(logits, out_hw)
    n, h, w, c = logits.shape
    oh, ow = out_hw
    lib = _library()
    idx, wt = _device_tables(h, oh, w, ow, logits.device)
    out = torch.empty((n, oh, ow), dtype=torch.uint8, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.asn_upsample_argmax(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            out.data_ptr(), idx.data_ptr(), wt.data_ptr(),
            n, h, w, c, oh, ow, stream)
    if err:
        raise RuntimeError(f"upsample_argmax kernel launch failed: "
                           f"cudaError_t {err}")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
