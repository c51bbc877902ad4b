"""Kernel 1's run-by-column schedule on the CPU (csrc/upsample_argmax.cu).

The CUDA kernel runs only on the card (chip_smoke.py phase 3 holds it
against the plain version there). Its schedule is modelled here in numpy:
blocks of `rows_per_block` output rows, one run per row and pair of source
columns (i0 = j, i1 = min(j + 1, w - 1)), from `run_starts`, whose two
columns are lerped in height (f32, fmaf(w1, x1, w0 * x0)), `chunk_width`
channels at a time (a last chunk of fewer repeats its first channel), and whose
pixels take their width weights from the f64 formula the kernel evaluates
(src = x * s, frac = src - j), lerp in width and keep the first maximal
channel (strict >, within a chunk and against the earlier chunks' best).
The model's masks are held
against the port's plain version and the JAX package's exact resize with
argmax wherever the top-2 margin is not a near-tie (> 1e-4 of the largest
logit), and equal them exactly on ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptsegnet_tpu.ops.resize import resize_bilinear_align_corners as jax_resize
from adaptsegnet_tpu_torch.ops.kernels import upsample_argmax_plain
from adaptsegnet_tpu_torch.ops.kernels.upsample_argmax import (
    _MAX_SMEM,
    MAX_WIDTH,
    WIDTHS,
    _check,
    axis_tables,
    chunk_width,
    run_starts,
    smem_bytes,
)

F32 = np.float32


def fma32(a, b, c):
    """fmaf on f32 arrays: the exact product plus c, rounded once (the f64
    sum of an exact 48-bit product and an f32 rounds away from the f32
    result only on a double-rounding tie)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def lerp2(w0, x0, w1, x1):
    return fma32(w1, x1, (w0 * x0).astype(F32))


def rows_per_block(w, c, ow):  # the wrapper's _launch_plan
    return 2 if smem_bytes(c, ow, 2) <= _MAX_SMEM else 1


def second_tap(j, w, ow):
    """The kernel's i1 for run j: min(j + 1, w - 1), or j where w or W is
    1 (its scale is then 0)."""
    return j if w == 1 or ow == 1 else np.minimum(j + 1, w - 1)


def column_weights(w, ow):
    """The kernel's per-column weights: i0 = j of the pixel's run, then
    frac = f64(x) * s - j, w1 = f32(frac), w0 = f32(1 - frac)."""
    starts = run_starts(w, ow)
    sx = (w - 1) / (ow - 1) if w > 1 and ow > 1 else 0.0
    j = np.repeat(np.arange(w), np.diff(starts))
    frac = np.arange(ow, dtype=np.float64) * sx - j
    return j, (1.0 - frac).astype(F32), frac.astype(F32)


def argmax_model(x, out_hw):
    """The kernel's masks, block by block and run by run."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    r0, r1, rw0, rw1 = axis_tables(h, oh)
    starts = run_starts(w, ow)
    j, v0, v1 = column_weights(w, ow)
    x = x.astype(F32)
    out = np.zeros((n, oh, ow), np.uint8)
    rows = rows_per_block(w, c, ow)
    for oy0 in range(0, oh, rows):
        oy = np.arange(oy0, min(oy0 + rows, oh))
        staged = lerp2(rw0[oy, None, None], x[:, r0[oy]], rw1[oy, None, None],
                       x[:, r1[oy]])                          # (n, rows, w, c)
        for jj in range(w):
            lo, hi = starts[jj], starts[jj + 1]
            if lo >= hi:
                continue
            kept = arg = None
            width = chunk_width(c)
            for c0 in range(0, c, width):
                k = np.arange(width)
                ch = c0 + np.where(k < min(width, c - c0), k, 0)
                a = staged[:, :, jj][..., None, ch]           # the run's registers
                b = staged[:, :, second_tap(jj, w, ow)][..., None, ch]
                y = lerp2(v0[None, None, lo:hi, None], a, v1[None, None, lo:hi, None], b)
                best, top = y.max(-1), y.argmax(-1) + c0      # first maximal channel
                if kept is not None:                          # earlier chunks win ties
                    later = best > kept
                    best, top = np.where(later, best, kept), np.where(later, top, arg)
                kept, arg = best, top
            out[:, oy, lo:hi] = arg
    return out


SHAPES = [
    ((1, 64, 128, 19), (1024, 2048)),  # the eval shape
    ((2, 8, 16, 19), (32, 256)),
    ((1, 4, 8, 5), (4, 8)),            # identity size, one short chunk
    ((1, 16, 32, 16), (256, 512)),     # 16 classes: one chunk, 3 repeats
    ((1, 64, 128, 20), (256, 512)),    # one chunk of 24, 4 repeats
    ((1, 6, 10, 38), (24, 80)),        # one chunk of 40
    ((2, 5, 7, 45), (17, 29)),         # one chunk of 48
    ((1, 4, 6, 100), (9, 13)),         # two chunks of 64, the last of 36
    ((1, 5, 1, 3), (9, 7)),            # one source column: one run per row
    ((1, 6, 9, 4), (1, 1)),            # one output pixel
]


@pytest.mark.parametrize("shape,out_hw", SHAPES, ids=str)
def test_runs_cover_each_column_once_with_the_tables_weights(shape, out_hw):
    """Run j holds exactly the output columns whose first tap is j; its
    second tap is the tables'; the f64 weights equal the tables' bit for
    bit."""
    _, _, w, _ = shape
    ow = out_hw[1]
    i0, i1, w0, w1 = axis_tables(w, ow)
    starts = run_starts(w, ow)
    assert starts[0] == 0 and starts[-1] == ow and (np.diff(starts) >= 0).all()
    j, v0, v1 = column_weights(w, ow)
    np.testing.assert_array_equal(j, i0)
    np.testing.assert_array_equal(second_tap(j, w, ow), i1)
    np.testing.assert_array_equal(v0.view(np.uint32), w0.view(np.uint32))
    np.testing.assert_array_equal(v1.view(np.uint32), w1.view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_hw", SHAPES, ids=str)
def test_model_masks_match_plain_and_jax(rng, shape, out_hw, dtype):
    x = rng.standard_normal(shape).astype(F32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    got = argmax_model(x, out_hw)
    plain = upsample_argmax_plain(torch.from_numpy(x), out_hw).numpy()
    up = np.asarray(jax_resize(jnp.asarray(x), out_hw, exact=True))
    top2 = np.sort(up, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4 * np.abs(up).max()
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], plain[clear])
    np.testing.assert_array_equal(got[clear], up.argmax(-1)[clear])


@pytest.mark.parametrize("c,ties,want", [
    (19, (3, 11), {0, 3}),      # within one chunk
    (100, (70, 90), {0, 70}),   # within a later chunk (chunks of 64)
    (100, (80, 3), {0, 3}),     # across chunks: the earlier chunk's wins
])
def test_model_takes_the_first_maximal_channel(c, ties, want):
    x = np.zeros((1, 4, 8, c), F32)
    x[..., ties[0]] = 5.0
    x[..., ties[1]] = 5.0
    x[0, 1, 2, 0] = 5.0  # a three-way tie around one source cell
    got = argmax_model(x, (16, 32))
    plain = upsample_argmax_plain(torch.from_numpy(x), (16, 32)).numpy()
    np.testing.assert_array_equal(got, plain)
    assert set(np.unique(got)) <= want


def test_rows_per_block_and_shared_memory():
    """Two output rows of labels per block at the eval shape (4 KB of
    shared memory); one where two do not fit; with more than MAX_WIDTH
    channels, rows of f32 best values too; the wrapper refuses a row that
    does not fit."""
    assert rows_per_block(128, 19, 2048) == 2 and smem_bytes(19, 2048, 2) == 4096
    assert rows_per_block(128, 19, 200_000) == 1
    assert smem_bytes(MAX_WIDTH, 2048, 2) == 4096
    assert smem_bytes(MAX_WIDTH + 1, 2048, 2) == 4096 + 4 * 4096
    assert rows_per_block(128, 100, 30_000) == 1
    _check((1, 2, 4, 19), torch.float32, (4, 200_000))
    _check((1, 2, 4, 100), torch.float32, (4, 46_000))
    with pytest.raises(ValueError, match="shared memory"):
        _check((1, 2, 4, 19), torch.float32, (4, 240_000))
    with pytest.raises(ValueError, match="shared memory"):
        _check((1, 2, 4, 100), torch.float32, (4, 47_000))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check((1, 2, 4, 19), torch.float16, (4, 8))


@pytest.mark.parametrize("c,want", [
    (1, 8), (8, 8), (9, 12), (16, 16), (19, 19), (20, 24), (32, 32),
    (33, 40), (45, 48), (64, 64), (65, 40), (100, 64), (150, 64), (255, 64),
])
def test_chunk_width(c, want):
    """The least width that holds C; above MAX_WIDTH, the least that holds
    an equal share of ceil(C / MAX_WIDTH) chunks, so no chunk is wider than
    MAX_WIDTH and the chunks cover C."""
    width = chunk_width(c)
    assert width == want and width in WIDTHS
    chunks = -(-c // MAX_WIDTH)
    assert -(-c // width) == chunks
