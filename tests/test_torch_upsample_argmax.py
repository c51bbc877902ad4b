"""The port's upsample+argmax tail (plain version, on the CPU) vs the JAX
package's Pallas kernel (interpret mode) and its exact XLA resize."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from adaptsegnet_tpu.ops.pallas.upsample_argmax import (
    _hweights,
    upsample_argmax as jax_upsample_argmax,
)
from adaptsegnet_tpu.ops.resize import (
    _interp_matrix as jax_interp_matrix,
    resize_bilinear_align_corners as jax_resize,
)
from adaptsegnet_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
    upsample_argmax,
)
from adaptsegnet_tpu_torch.ops.kernels.upsample_argmax import axis_tables
from adaptsegnet_tpu_torch.ops.resize import _interp_matrix

# The shapes of tests/test_pallas_kernels.py.
SHAPES = [
    ((1, 8, 16, 19), (64, 128)),
    ((2, 8, 16, 19), (32, 256)),
    ((1, 4, 8, 5), (4, 8)),  # identity size
]


def top2_margin(up: np.ndarray) -> np.ndarray:
    s = np.sort(up, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_plain_matches_pallas_kernel_bf16(rng, shape, out_hw):
    xj = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    ref = np.asarray(jax_upsample_argmax(xj, out_hw, interpret=True))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    ours = upsample_argmax(xt, out_hw).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    # The TPU kernel rounds its width-interpolated scratch to bf16
    # (ops/pallas/upsample_argmax.py:117); the port interpolates in f32, so
    # near-ties of random logits flip (as in tests/test_pallas_kernels.py).
    agree = (ours == ref).mean()
    assert agree > 0.99, f"only {agree:.4%} agreement"


@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_plain_matches_exact_resize_f32(rng, shape, out_hw):
    x = rng.standard_normal(shape).astype(np.float32)
    up = np.asarray(jax_resize(jnp.asarray(x), out_hw, exact=True))
    ref = up.argmax(-1)
    ours = upsample_argmax(torch.from_numpy(x), out_hw).numpy()
    eq = ours == ref
    # Same matrices, sums in another order: only f32 near-ties may flip.
    assert eq.mean() >= 0.9999
    assert (top2_margin(up)[~eq] < 1e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_index_tiebreak(dtype):
    x = torch.zeros((1, 4, 8, 3), dtype=dtype)
    x[..., 1] = 5.0
    x[..., 2] = 5.0
    assert (upsample_argmax(x, (8, 16)) == 1).all()


@pytest.mark.parametrize("in_len,out_len", [
    (64, 1024), (128, 2048), (8, 64), (16, 256), (4, 4), (1, 5), (5, 1),
])
def test_tables_match_jax(in_len, out_len):
    i0, i1, w0, w1 = axis_tables(in_len, out_len)
    j0, j1, jw1 = _hweights(in_len, out_len)
    np.testing.assert_array_equal(i0, j0)
    np.testing.assert_array_equal(i1, j1)
    np.testing.assert_array_equal(w1, jw1)
    # The tables are the interpolation matrix's non-zeros, bit for bit.
    m = np.zeros((out_len, in_len), np.float32)
    rows = np.arange(out_len)
    np.add.at(m, (rows, i0), w0)
    np.add.at(m, (rows, i1), w1)
    np.testing.assert_array_equal(m, jax_interp_matrix(in_len, out_len))
    np.testing.assert_array_equal(m, _interp_matrix(in_len, out_len))


def test_cpu_tensor_takes_plain_version(rng):
    reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((1, 8, 16, 19)).astype(np.float32))
    upsample_argmax(x, (64, 128))
    counts = launch_counts()
    assert counts["upsample_argmax"] == 0
    assert set(counts.values()) == {0}
