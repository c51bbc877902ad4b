"""Kernel 6 of the port (the fused upsample + warp) against the JAX package
on the CPU.

The port's plain version (ops/kernels/upsample_warp.py, the function the
CUDA kernel computes, taken for CPU tensors) is held against the Pallas
kernel in interpret mode in the layout the JAX train step uses
(`_sample_upsampled(..., interpret=True, pixel_lanes=True,
planar_out=True)`), forward, dx and d(iy, ix), and the whole warp op
against the unfused XLA composition warp_with_flow(upsample_logits(...)).
Coordinates include the clamped edges and the exact boundary (iy = H-1,
ix = 0). Tolerances: f32 rtol 1e-5 plus 1e-5 of the largest magnitude
(both sum the same f32 products in other orders). bf16: the Pallas kernel
rounds its x-direction weights to bf16 for the MXU and the port keeps them
f32 (ROADMAP.md §3), so outputs agree within one bf16 ulp (2^-7 relative)
plus 2e-3 of the largest magnitude, and the f32 d-flow within 4e-3 of its
largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.ops.pallas.upsample_warp import (
    _coords_from_flow,
    _sample_upsampled,
    upsample_warp as jax_upsample_warp,
)
from adaptsegnet_tpu.ops.resize import upsample_logits as jax_upsample_logits
from adaptsegnet_tpu.ops.sampling import warp_with_flow as jax_warp_with_flow
from adaptsegnet_tpu_torch.ops import upsample_warp as warp_op
from adaptsegnet_tpu_torch.ops.kernels import upsample_warp as k6
from adaptsegnet_tpu_torch.ops.resize import upsample_logits
from adaptsegnet_tpu_torch.ops.sampling import warp_with_flow

SHAPES = [(1, 8, 16, 19, 32, 64), (2, 5, 6, 3, 20, 30)]  # P = 600 pads


def _case(rng, n, hl, wl, c, hh, wh):
    x = rng.standard_normal((n, hl, wl, c)).astype(np.float32)
    flow = (rng.standard_normal((n, 2, hh, wh)) * 0.5).astype(np.float32)
    flow[:, :, 0, :4] = 8.0    # tanh -> 1: clamped at the bottom/right edge
    flow[:, :, 1, :4] = -8.0   # clamped at the top/left edge
    g = rng.standard_normal((n, c, hh, wh)).astype(np.float32)
    iy, ix = (np.array(a) for a in _coords_from_flow(
        jnp.asarray(flow), (hh, wh), planar=True))
    iy[:, 2, :3], ix[:, 2, :3] = hh - 1, 0.0  # the exact boundary
    return x, flow, g, iy, ix


def _close(got, ref, rtol, scale_tol, ulp=False):
    """Assert the tolerance; return max |got - ref| / max |ref|."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    atol = scale_tol * np.abs(ref).max()
    if ulp:
        assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + atol), \
            np.abs(got - ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret(rng, shape, dtype, record_property):
    """The largest error over the largest value of each output goes into
    the JUnit report (`record_property`): the measured gap."""
    x, _, g, iy, ix = _case(rng, *shape)
    hl, wl = shape[1:3]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def f(xj, iyj, ixj):
        return _sample_upsampled(xj, iyj, ixj, True, False, True, True)

    out, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(iy), jnp.asarray(ix))
    dx, diy, dix = vjp(jnp.asarray(g, jdt))
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    tiy, tix = torch.from_numpy(iy), torch.from_numpy(ix)
    got = k6.upsample_warp_fwd(tx, tiy, tix)
    got_dx = k6.upsample_warp_dx(tg, tiy, tix, (hl, wl))
    got_diy, got_dix = k6.upsample_warp_dflow(tx, tg, tiy, tix)
    assert got.dtype == got_dx.dtype == tdt and got.shape == out.shape
    assert got_dx.shape == dx.shape and got_diy.dtype == torch.float32
    f32 = dtype == "float32"
    for name, a, b in (("fwd", got, out), ("dx", got_dx, dx)):
        record_property(name, _close(a.float(), b.astype(jnp.float32), 1e-5,
                                     1e-5 if f32 else 2e-3, ulp=not f32))
    for name, a, b in (("diy", got_diy, diy), ("dix", got_dix, dix)):
        record_property(name, _close(a, b, 1e-5, 1e-5 if f32 else 4e-3))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_warp_op_matches_xla_composition(rng, shape):
    """upsample_warp(x, flow) (coords + the autograd Function) against
    warp_with_flow(upsample_logits(x)) in f32: values and the gradients
    with respect to x and the raw flow (tanh and clamp included); the
    port's own unfused composition (ops/sampling.py) too."""
    n, hl, wl, c, hh, wh = shape
    x, flow, g, _, _ = _case(rng, *shape)

    def comp(xj, fj):
        up = jax_upsample_logits(xj, (hh, wh))
        return jax_warp_with_flow(up, jnp.transpose(fj, (0, 2, 3, 1)))

    ref, vjp = jax.vjp(comp, jnp.asarray(x), jnp.asarray(flow))
    ref_dx, ref_df = vjp(jnp.asarray(g).transpose(0, 2, 3, 1))
    tx = torch.from_numpy(x).requires_grad_(True)
    tf = torch.from_numpy(flow).requires_grad_(True)
    out = warp_op.upsample_warp(tx, tf, (hh, wh))
    (out * torch.from_numpy(g)).sum().backward()
    ref_planar = np.asarray(ref).transpose(0, 3, 1, 2)
    _close(out.detach(), ref_planar, 1e-5, 1e-5)
    _close(tx.grad, ref_dx, 1e-5, 1e-5)
    _close(tf.grad, ref_df, 1e-4, 1e-4)
    unfused = warp_with_flow(upsample_logits(torch.from_numpy(x), (hh, wh)),
                             torch.from_numpy(flow).permute(0, 2, 3, 1))
    _close(unfused, ref, 1e-5, 1e-5)
    fused_jax = jax_upsample_warp(jnp.asarray(x), jnp.asarray(flow), planar=True,
                                  planar_out=True)
    _close(out.detach(), fused_jax, 1e-5, 1e-5)


def test_coords_from_flow_matches_jax(rng):
    """Pixel-unit sample positions from a planar flow; the identity grids
    differ by at most an f32 ulp (f64 linspace rounded vs jnp.linspace)."""
    flow = (rng.standard_normal((2, 2, 32, 64)) * 2).astype(np.float32)
    jiy, jix = _coords_from_flow(jnp.asarray(flow), (32, 64), planar=True)
    iy, ix = warp_op.coords_from_flow(torch.from_numpy(flow), (32, 64))
    assert iy.dtype == ix.dtype == torch.float32 and iy.shape == (2, 32, 64)
    np.testing.assert_allclose(iy.numpy(), np.asarray(jiy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ix.numpy(), np.asarray(jix), rtol=0, atol=1e-5)
    assert iy.min() >= 0 and iy.max() <= 31 and ix.max() <= 63


def test_function_skips_dflow_for_constant_coords(rng, monkeypatch):
    """The autograd Function runs only the directions asked for: dx alone
    when the flow needs no grad (the train step), d-flow alone when x
    needs none."""
    calls = []
    for name in ("upsample_warp_dx", "upsample_warp_dflow"):
        fn = getattr(k6, name)
        monkeypatch.setattr(k6, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    x, flow, g, _, _ = _case(rng, 1, 8, 16, 19, 32, 64)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = warp_op.upsample_warp(tx, torch.from_numpy(flow))
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == ["upsample_warp_dx"] and tx.grad is not None
    calls.clear()
    tf = torch.from_numpy(flow).requires_grad_(True)
    out = warp_op.upsample_warp(torch.from_numpy(x), tf)
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == ["upsample_warp_dflow"] and tf.grad is not None


def test_wrappers_raise_for_other_devices():
    x = torch.zeros((1, 2, 2, 3), device="meta")
    iy = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no upsample_warp_fwd kernel"):
        k6.upsample_warp_fwd(x, iy, iy)
