"""Fused bilinear-upsample + channel-argmax: the eval tail as one CUDA kernel.

Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/upsample_argmax.py
(`upsample_argmax`): (N, h, w, C) NHWC logits -> (N, H, W) uint8, the
first-index argmax of the align_corners=True bilinear upsample. The kernel
is csrc/upsample_argmax.cu (its note gives the design). On the H100 it is
bound by operations: about 1.7e8 f32 lerp and compare operations at the eval
shape (64x128x19 -> 1024x2048) against ~2.4 MB of traffic. A thread owns
the run of output pixels between one pair of source columns (`run_starts`),
lerps the pair's two columns in height into registers, a chunk of channels
at a time (`chunk_width`: one chunk of 19 at C = 19), and, pixel by pixel,
lerps in width and compares; with more than MAX_WIDTH channels each
pixel's best value waits in shared memory between chunks.

`upsample_argmax` takes the plain PyTorch version below only for a tensor
on the CPU; a CUDA tensor launches the kernel or raises. The plain version
is the kernel's function: upsample with ops/resize.py's matrices in f32
(for bf16 input too), then argmax. `upsample_argmax.launches` counts the
kernel's launches. The wrapper checks each shape and builds its tables
once (`_launch_plan`); a call checks the device and the layout, looks the
plan up, allocates the output and launches.
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
WIDTHS = (8, 12, 16, 19, 24, 32, 40, 48, 64)  # the kernel's chunk widths
MAX_WIDTH = WIDTHS[-1]            # csrc/upsample_argmax.cu::kMaxW


def chunk_width(c: int) -> int:
    """csrc/upsample_argmax.cu::kernel_for: the channels a thread holds in
    registers at a time, the least width that holds C, or for C > MAX_WIDTH
    an equal share of ceil(C / MAX_WIDTH) chunks."""
    chunks = -(-c // MAX_WIDTH)
    return next(w for w in WIDTHS if w >= -(-c // chunks))


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


def run_starts(in_len: int, out_len: int) -> np.ndarray:
    """The kernel's runs of one axis: entry j (0 <= j <= in_len) is the first
    output index whose first tap i0 is >= j, so the outputs that lie between
    source columns j and j + 1 (or on the last one) are
    [starts[j], starts[j + 1]). The taps are nondecreasing."""
    i0 = axis_tables(in_len, out_len)[0]
    return np.searchsorted(i0, np.arange(in_len + 1), side="left").astype(np.int32)


def upsample_argmax_plain(logits: torch.Tensor,
                          out_hw: tuple[int, int]) -> torch.Tensor:
    """The plain PyTorch version: f32 matrix upsample, then argmax."""
    up = resize_bilinear_align_corners(logits.float(), out_hw, exact=True)
    return up.argmax(dim=-1).to(torch.uint8)


def smem_bytes(c: int, ow: int, rows: int) -> int:
    """csrc/upsample_argmax.cu::smem_bytes: a block's rows of uint8 labels
    and, where C > MAX_WIDTH, of f32 best values (16-byte aligned)."""
    px = rows * ow
    return -(-px // 16) * 16 + 4 * px if c > MAX_WIDTH else px


def _check(shape: tuple[int, ...], dtype: torch.dtype,
           out_hw: tuple[int, int]) -> None:
    """What the kernel takes, by shape and dtype: (N, h, w, C) f32 or bf16
    logits, 1 <= C <= 255, a grid that fits, a row of labels (and of best
    values where C > MAX_WIDTH) that fits in shared memory."""
    if len(shape) != 4:
        raise ValueError(f"logits must be (N, h, w, C), got {shape}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {dtype}")
    n, h, w, c = shape
    oh, ow = out_hw
    if not 1 <= c <= 255:
        raise ValueError(f"channel count {c} does not fit uint8 (1..255)")
    if min(n, h, w, oh, ow) < 1 or max(n, oh) > _MAX_GRID_YZ:
        raise ValueError(f"unsupported shape {shape} -> {out_hw}")
    if smem_bytes(c, ow, 1) > _MAX_SMEM:
        raise ValueError(f"a row of W = {ow} labels exceeds the kernel's "
                         "shared memory")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("upsample_argmax")
    fn = lib.asn_upsample_argmax
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double] + [
                   ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _launch_plan(shape: tuple[int, ...], dtype: torch.dtype,
                 out_hw: tuple[int, int], device: torch.device):
    """Once per shape, dtype and device: the checks of `_check`, then the
    kernel's entry, the output's shape, its arguments between the output
    and the stream, and the tables they point to. The tables: int32 row
    taps and run starts, f32 row weights (rows, then columns); the column
    scale in f64 (each column's weights are computed in the kernel from it,
    by axis_tables' formula); the output rows per block, 2, or 1 where two
    do not fit in shared memory (`smem_bytes`)."""
    _check(shape, dtype, out_hw)
    n, h, w, c = shape
    oh, ow = out_hw
    r0, r1, rw0, rw1 = axis_tables(h, oh)
    idx = torch.from_numpy(np.concatenate([r0, r1, run_starts(w, ow)])).to(device)
    wt = torch.from_numpy(np.concatenate([rw0, rw1])).to(device)
    sx = (w - 1) / (ow - 1) if w > 1 and ow > 1 else 0.0
    rows = 2 if smem_bytes(c, ow, 2) <= _MAX_SMEM else 1
    args = (idx.data_ptr(), wt.data_ptr(), sx, n, h, w, c, oh, ow, rows)
    return _library().asn_upsample_argmax, (n, oh, ow), args, (idx, wt)


def upsample_argmax(logits: torch.Tensor,
                    out_hw: tuple[int, int]) -> torch.Tensor:
    """(N, h, w, C) logits -> (N, H, W) uint8 argmax of the align-corners
    bilinear upsample to out_hw; the first maximal channel wins. A call's
    host work: the device and layout checks, one cached lookup of the
    checked shape's plan, the output's allocation and the launch."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if not _build.on_cuda(logits, "upsample_argmax"):
        return upsample_argmax_plain(logits, out_hw)
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous NHWC")
    fn, out_shape, args, _ = _launch_plan(tuple(logits.shape), logits.dtype,
                                          out_hw, logits.device)
    out = torch.empty(out_shape, dtype=torch.uint8, device=logits.device)
    _build.raise_on(fn(logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                       out.data_ptr(), *args, _build.stream(logits)),
                    "upsample_argmax")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
