"""Plain versions of the train kernels (2: conv3x3_dil, 5: conv4x4_s2, 4:
conv4x4_patch) against the JAX Pallas kernels in interpret mode, bf16, in
the forward and every VJP direction; and the wrappers' device rules.

On the CPU each wrapper runs its plain version, which is the function the
CUDA kernel computes: exact products of the bf16 operands summed in f32,
rounded once (bf16 outputs) or kept in f32 (wgrad). The Pallas kernels do
the same with another summation order. Tolerance for bf16 outputs: one
bf16 ulp of the reference (2^-7 relative; the two f32 sums may straddle a
rounding boundary) plus 1e-3 of the largest magnitude; f32 outputs: 1e-4
relative plus 1e-4 of the largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.ops.pallas.conv3x3_dil import conv3x3_dil_mxu
from adaptsegnet_tpu.ops.pallas.conv4x4_patch import conv4x4_s2_phases_planar
from adaptsegnet_tpu.ops.pallas.conv4x4_s2 import conv4x4_s2_mxu
from adaptsegnet_tpu_torch.ops.kernels import (
    conv3x3_dil_dgrad,
    conv3x3_dil_fwd,
    conv4x4_patch_dgrad,
    conv4x4_patch_fwd,
    conv4x4_patch_wgrad,
    conv4x4_s2_dgrad,
    conv4x4_s2_fwd,
    conv4x4_s2_wgrad,
    launch_counts,
    reset_launch_counts,
)


def bf16_values(rng, shape, scale=1.0):
    """f32 numpy array of bf16-representable values."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def tb(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def assert_bf16_close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    tol = 2.0 ** -7 * np.abs(ref) + 1e-3 * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


def assert_f32_close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("cin,cout,d", [(128, 128, 2), (128, 256, 4)])
def test_conv3x3_dil_plain_matches_pallas(rng, cin, cout, d):
    """Forward, and dgrad = the forward kernel on the flipped, io-swapped
    weights (adaptsegnet_tpu/ops/conv3x3.py:115-117)."""
    x = bf16_values(rng, (1, 16, 24, cin))
    dy = bf16_values(rng, (1, 16, 24, cout))
    k = bf16_values(rng, (3, 3, cin, cout), 0.05)  # HWIO
    w = tb(k.transpose(3, 2, 0, 1))                # OIHW
    ref = conv3x3_dil_mxu(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(k, jnp.bfloat16), d, interpret=True)
    got = conv3x3_dil_fwd(tb(x), w, d)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(as_np(got), np.asarray(ref.astype(jnp.float32)))

    kf = jnp.flip(jnp.asarray(k, jnp.bfloat16), axis=(0, 1)).transpose(0, 1, 3, 2)
    ref_dx = conv3x3_dil_mxu(jnp.asarray(dy, jnp.bfloat16), kf, d, interpret=True)
    got_dx = conv3x3_dil_dgrad(tb(dy), w, d)
    assert got_dx.shape == (1, 16, 24, cin)
    assert_bf16_close(as_np(got_dx), np.asarray(ref_dx.astype(jnp.float32)))


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 16, 24, 64, 128),
                                            (1, 12, 16, 128, 256)])
def test_conv4x4_s2_plain_matches_pallas(rng, n, h, w, cin, cout):
    """Forward, dx, dW (f32, before any rounding to the weight's dtype)
    and the bias grad, against jax.vjp of the Pallas custom VJP."""
    x = bf16_values(rng, (n, h, w, cin))
    k = bf16_values(rng, (4, 4, cin, cout), 0.05)
    b = bf16_values(rng, (cout,), 0.5)
    dy = bf16_values(rng, (n, h // 2, w // 2, cout))
    y, vjp = jax.vjp(lambda x_, k_, b_: conv4x4_s2_mxu(x_, k_, b_, True),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(k),
                     jnp.asarray(b))
    gx, gk, gb = vjp(jnp.asarray(dy, jnp.bfloat16))
    wt = tb(k.transpose(3, 2, 0, 1))
    assert_bf16_close(as_np(conv4x4_s2_fwd(tb(x), wt, tb(b))),
                      np.asarray(y.astype(jnp.float32)))
    assert_bf16_close(as_np(conv4x4_s2_dgrad(tb(dy), wt, (h, w))),
                      np.asarray(gx.astype(jnp.float32)))
    dk = conv4x4_s2_wgrad(tb(x), tb(dy))
    assert dk.dtype == torch.float32 and dk.shape == (cout, cin, 4, 4)
    assert_f32_close(dk.numpy().transpose(2, 3, 1, 0), np.asarray(gk))
    assert_f32_close(tb(dy).float().sum((0, 1, 2)).numpy(), np.asarray(gb))


def _planar_phases(xp):
    """(N, C, H+2, W+2) padded dense -> the 4 planar parity phases of the
    JAX kernel, phase_rs[u, v] = xp[2u + r, 2v + s] (index 2r + s)."""
    return tuple(jnp.asarray(xp[:, :, r::2, s::2]) for r in (0, 1) for s in (0, 1))


def _dense_from_phases(dphases, h, w):
    """Inverse of _planar_phases followed by dropping the pad ring."""
    n, c = dphases[0].shape[:2]
    dxp = np.zeros((n, c, h + 2, w + 2), np.float32)
    for r in (0, 1):
        for s in (0, 1):
            dxp[:, :, r::2, s::2] = np.asarray(dphases[2 * r + s], np.float32)
    return dxp[:, :, 1:-1, 1:-1]


@pytest.mark.parametrize("n,h,w", [(1, 16, 24), (2, 8, 16)])
def test_conv4x4_patch_plain_matches_pallas(rng, n, h, w):
    """The port's kernel reads the dense planar map with zero padding on
    load; the JAX kernel its four parity phases of the padded map. Same
    function: forward, dW, db, and dx (the phase cotangents at the interior
    positions)."""
    c, cout = 19, 64
    x = np.asarray(jnp.asarray(
        jax.nn.softmax(rng.standard_normal((n, c, h, w)), axis=1),
        jnp.bfloat16).astype(jnp.float32))
    k = bf16_values(rng, (4, 4, c, cout), 0.05)
    b = bf16_values(rng, (cout,), 0.5)
    dy = bf16_values(rng, (n, h // 2, w // 2, cout))
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    phases = tuple(p.astype(jnp.bfloat16) for p in _planar_phases(xp))
    y, vjp = jax.vjp(
        lambda ps, k_, b_: conv4x4_s2_phases_planar(ps, k_, b_, True),
        phases, jnp.asarray(k), jnp.asarray(b))
    dphases, gk, gb = vjp(jnp.asarray(dy, jnp.bfloat16))

    wt = tb(k.transpose(3, 2, 0, 1))
    got = conv4x4_patch_fwd(tb(x), wt, tb(b))
    assert got.shape == (n, h // 2, w // 2, cout)
    assert_bf16_close(as_np(got), np.asarray(y.astype(jnp.float32)))
    dx = conv4x4_patch_dgrad(tb(dy), wt, (h, w))
    assert dx.shape == (n, c, h, w) and dx.dtype == torch.bfloat16
    assert_bf16_close(as_np(dx), _dense_from_phases(dphases, h, w))
    dk = conv4x4_patch_wgrad(tb(x), tb(dy))
    assert dk.shape == (cout, c, 4, 4)
    assert_f32_close(dk.numpy().transpose(2, 3, 1, 0), np.asarray(gk))
    assert_f32_close(tb(dy).float().sum((0, 1, 2)).numpy(), np.asarray(gb))


def test_kernel_weight_layouts(rng):
    """The weight matrices the wrappers hand to the CUDA kernels (their
    layout contract with csrc/), against a tap-by-tap construction."""
    from adaptsegnet_tpu_torch.ops.kernels import conv4x4_patch as k4
    from adaptsegnet_tpu_torch.ops.kernels import conv4x4_s2 as k5

    w = torch.from_numpy(rng.standard_normal((8, 6, 4, 4)).astype(np.float32))
    wcls = k5.dgrad_weights(w)
    assert wcls.shape == (4, 6, 4 * 8) and wcls.is_contiguous()
    for py in (0, 1):
        for px in (0, 1):
            for a in (0, 1):
                for b in (0, 1):
                    t = 2 * a + b
                    np.testing.assert_array_equal(
                        wcls[2 * py + px, :, t * 8:(t + 1) * 8].numpy(),
                        w[:, :, 1 - py + 2 * a, 1 - px + 2 * b].numpy().T)
    # kernel 4: the forward's K-major (64, 16*C) weights, column
    # c*16 + ky*4 + kx, a view of OIHW; the dgrad's parity classes at C = 19
    # (the same matrices as kernel 5's, N = C padded to 32 by the tensor map)
    w4 = torch.from_numpy(rng.standard_normal((64, 19, 4, 4)).astype(np.float32))
    wt4 = k4.kmajor_weights(w4)
    assert wt4.shape == (64, 304) and wt4.data_ptr() == w4.data_ptr()
    for c, ky, kx in ((0, 0, 0), (5, 2, 3), (18, 3, 1)):
        np.testing.assert_array_equal(wt4[:, c * 16 + ky * 4 + kx].numpy(),
                                      w4[:, c, ky, kx].numpy())
    wcls4 = k5.dgrad_weights(w4)
    assert wcls4.shape == (4, 19, 256) and wcls4.is_contiguous()
    for py in (0, 1):
        for px in (0, 1):
            for a in (0, 1):
                for b in (0, 1):
                    t = 2 * a + b
                    np.testing.assert_array_equal(
                        wcls4[2 * py + px, :, t * 64:(t + 1) * 64].numpy(),
                        w4[:, :, 1 - py + 2 * a, 1 - px + 2 * b].numpy().T)


def test_cpu_tensors_take_the_plain_versions(rng):
    reset_launch_counts()
    x = tb(bf16_values(rng, (1, 8, 8, 128)))
    w = tb(bf16_values(rng, (128, 128, 3, 3), 0.05))
    conv3x3_dil_fwd(x, w, 2)
    conv3x3_dil_dgrad(x, w, 2)
    x5 = tb(bf16_values(rng, (1, 8, 8, 64)))
    w5 = tb(bf16_values(rng, (128, 64, 4, 4), 0.05))
    conv4x4_s2_wgrad(x5, conv4x4_s2_fwd(x5, w5, None))
    assert set(launch_counts().values()) == {0}


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("call", [
    lambda: conv3x3_dil_fwd(_meta(1, 8, 8, 128), _meta(128, 128, 3, 3), 2),
    lambda: conv3x3_dil_dgrad(_meta(1, 8, 8, 128), _meta(128, 128, 3, 3), 2),
    lambda: conv4x4_s2_fwd(_meta(1, 8, 8, 64), _meta(128, 64, 4, 4), None),
    lambda: conv4x4_s2_dgrad(_meta(1, 4, 4, 128), _meta(128, 64, 4, 4), (8, 8)),
    lambda: conv4x4_s2_wgrad(_meta(1, 8, 8, 64), _meta(1, 4, 4, 128)),
    lambda: conv4x4_patch_fwd(_meta(1, 19, 8, 8), _meta(64, 19, 4, 4), None),
    lambda: conv4x4_patch_dgrad(_meta(1, 4, 4, 64), _meta(64, 19, 4, 4), (8, 8)),
    lambda: conv4x4_patch_wgrad(_meta(1, 19, 8, 8), _meta(1, 4, 4, 64)),
], ids=["k2_fwd", "k2_dgrad", "k5_fwd", "k5_dgrad", "k5_wgrad", "k4_fwd",
        "k4_dgrad", "k4_wgrad"])
def test_wrappers_raise_on_other_devices(call):
    """A tensor neither on the CPU nor on a CUDA card is refused: no plain
    fallback."""
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        call()
