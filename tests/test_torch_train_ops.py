"""The port's differentiable ops of the train path against the JAX package's
on the CPU: conv3x3_s1 (forward, dx, dk), the ASPP backward, the maxpool
tie rule, the losses, the discriminator-input producer and the conv4x4
dispatches."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.models.layers import max_pool_3x3_s2 as jax_max_pool
from adaptsegnet_tpu.ops import losses as jax_losses
from adaptsegnet_tpu.ops.aspp import aspp_matmul
from adaptsegnet_tpu.ops.conv3x3 import conv3x3_s1 as jax_conv3x3_s1
from adaptsegnet_tpu.ops.conv4x4 import conv4x4_s2d_phases, conv4x4_stride2 as jax_c4
from adaptsegnet_tpu.ops.resize import upsample_softmax_s2d_planar
from adaptsegnet_tpu_torch.models.layers import max_pool_3x3_s2
from adaptsegnet_tpu_torch.ops import losses
from adaptsegnet_tpu_torch.ops.aspp import aspp_sum
from adaptsegnet_tpu_torch.ops.conv3x3 import conv3x3_s1
from adaptsegnet_tpu_torch.ops.conv4x4 import conv4x4_patch, conv4x4_stride2
from adaptsegnet_tpu_torch.ops.resize import upsample_softmax_planar


def to_bf16_values(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def assert_within_bf16(got, ref, rel_scale=1e-3):
    """One bf16 ulp of the reference plus `rel_scale` of its largest
    magnitude (the two sides sum exact f32 products in other orders)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    tol = 2.0 ** -7 * np.abs(ref) + rel_scale * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


@pytest.mark.parametrize("dtype,cin,cout,d", [
    ("float32", 32, 48, 1), ("float32", 64, 64, 2),
    ("bfloat16", 128, 128, 2), ("bfloat16", 128, 256, 4)])
def test_conv3x3_s1_matches_jax(rng, dtype, cin, cout, d):
    """Forward, dx and dk against JAX conv3x3_s1's custom VJP. f32: rtol
    1e-4. bf16 (d in {2, 4}, channels multiples of 128: the kernel-2 route,
    here its plain version): one bf16 ulp + 1e-3 of the largest value, dk
    rounded once to bf16 on both sides."""
    x = to_bf16_values(rng.standard_normal((1, 16, 20, cin)))
    k = to_bf16_values(rng.standard_normal((3, 3, cin, cout)) * 0.05)
    g = to_bf16_values(rng.standard_normal((1, 16, 20, cout)))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    y, vjp = jax.vjp(lambda x_, k_: jax_conv3x3_s1(x_, k_, d, True),
                     jnp.asarray(x, jd), jnp.asarray(k, jd))
    gx, gk = vjp(jnp.asarray(g, jd))

    td = getattr(torch, dtype)
    tx = torch.from_numpy(x.copy()).to(td).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    tw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(td).requires_grad_(True)
    ty = conv3x3_s1(tx, tw, d)
    ty.backward(torch.from_numpy(g).to(td).permute(0, 3, 1, 2))
    got = [ty.detach().permute(0, 2, 3, 1), tx.grad.permute(0, 2, 3, 1),
           tw.grad.permute(2, 3, 1, 0)]
    assert tw.grad.dtype == td
    for a, b in zip(got, (y, gx, gk)):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
        else:
            assert_within_bf16(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aspp_backward_matches_aspp_bwd(rng, dtype):
    """dx, per-branch dW and db against jax.vjp of aspp_matmul (its custom
    `_aspp_bwd`): the cotangent in the compute dtype, dx the f32 sum over
    branches cast once, dW and db in f32 for the f32 parameters. Tolerance:
    f32 rtol 1e-4; bf16 dx one bf16 ulp + 1e-3 of its largest value, dW
    and db rtol 1e-3 (f32 sums of the same exact products)."""
    dils = (6, 12, 18, 24)
    c = 64
    x = to_bf16_values(rng.standard_normal((1, 16, 20, c)))
    ks = [rng.standard_normal((3, 3, c, 19)).astype(np.float32) * 0.1 for _ in dils]
    bs = [rng.standard_normal(19).astype(np.float32) for _ in dils]
    g = to_bf16_values(rng.standard_normal((1, 16, 20, 19)))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda x_, k_, b_: aspp_matmul(x_, k_, b_, dils),
                     jnp.asarray(x, jd), [jnp.asarray(k) for k in ks],
                     [jnp.asarray(b) for b in bs])
    gx, gks, gbs = vjp(jnp.asarray(g, jd))

    td = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(td).permute(0, 3, 1, 2).requires_grad_(True)
    tws = [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
           for k in ks]
    tbs = [torch.from_numpy(b).requires_grad_(True) for b in bs]
    out = aspp_sum(tx, tws, tbs, dils)
    assert out.dtype == td
    out.backward(torch.from_numpy(g).to(td).permute(0, 3, 1, 2))
    dx = tx.grad.permute(0, 2, 3, 1).float().numpy()
    ref_dx = np.asarray(gx.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(dx, ref_dx, rtol=1e-4, atol=1e-5)
    else:
        assert tx.grad.dtype == torch.bfloat16
        assert_within_bf16(dx, ref_dx)
    rtol = 1e-4 if dtype == "float32" else 1e-3
    for tw, tb_, gk, gb in zip(tws, tbs, gks, gbs):
        assert tw.grad.dtype == torch.float32
        np.testing.assert_allclose(tw.grad.numpy().transpose(2, 3, 1, 0),
                                   np.asarray(gk), rtol=rtol,
                                   atol=rtol * np.abs(gk).max())
        np.testing.assert_allclose(tb_.grad.numpy(), np.asarray(gb),
                                   rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("shape", [(1, 9, 13, 4), (2, 16, 16, 3)])
def test_maxpool_tie_rule_matches_jax_vjp(rng, shape):
    """Integer inputs in {0, 1, 2} tie in most windows; torch's backward and
    the JAX custom VJP route each window's gradient to the same (first, in
    row-major scan order) maximum: the same pixels receive gradient, and
    the values agree to f32 rounding (a pixel that is the maximum of several
    overlapping windows sums their gradients in another order; a routing
    difference would be an error of order 1)."""
    x = rng.integers(0, 3, shape).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jax_max_pool(a, False), jnp.asarray(x))
    g = rng.standard_normal(y.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ty = max_pool_3x3_s2(tx)
    np.testing.assert_array_equal(ty.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y))
    ty.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    got = tx.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got != 0, np.asarray(ref) != 0)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ignored", ["some", "all"])
def test_cross_entropy_matches_jax(rng, ignored):
    """Value and logits grad, rtol 1e-5; every pixel ignored gives 0 (torch
    would give NaN) on both sides."""
    logits = rng.standard_normal((2, 6, 7, 19)).astype(np.float32)
    labels = rng.integers(0, 19, (2, 6, 7))
    labels[0, :2] = 255
    if ignored == "all":
        labels[:] = 255
    ref, gref = jax.value_and_grad(jax_losses.cross_entropy_2d)(
        jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_(True)
    ours = losses.cross_entropy_2d(t, torch.from_numpy(labels))
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gref), rtol=1e-5,
                               atol=1e-7)
    if ignored == "all":
        assert ours.item() == 0.0


@pytest.mark.parametrize("mode", ["LS", "Vanilla"])
@pytest.mark.parametrize("target", [0.0, 1.0])
def test_gan_losses_match_jax(rng, mode, target):
    x = rng.standard_normal((2, 3, 5, 1)).astype(np.float32) * 3
    ref = jax_losses.gan_loss(mode)(jnp.asarray(x), target)
    ours = losses.gan_loss(mode)(torch.from_numpy(x), target)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        losses.gan_loss("WGAN")


def test_discriminator_input_matches_jax_phases(rng):
    """The dense planar softmax map, split into the parity phases of its
    zero-padded form, equals JAX upsample_softmax_s2d_planar (f32, exact
    matrices): same map, another layout."""
    logits = rng.standard_normal((2, 5, 7, 19)).astype(np.float32)
    out_hw = (16, 24)
    ref = upsample_softmax_s2d_planar(jnp.asarray(logits), out_hw)
    sm = upsample_softmax_planar(torch.from_numpy(logits), out_hw)
    assert sm.shape == (2, 19, 16, 24)
    xp = np.pad(sm.numpy(), ((0, 0), (0, 0), (1, 1), (1, 1)))
    for r in (0, 1):
        for s in (0, 1):
            np.testing.assert_allclose(xp[:, :, r::2, s::2],
                                       np.asarray(ref[2 * r + s]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cin,cout", [(8, 4), (64, 128)])
def test_conv4x4_stride2_grads_match_jax(rng, cin, cout):
    """f32 dispatch (library conv) and the bf16 kernel-5 route (its plain
    version here) against JAX conv4x4_stride2: output and grads."""
    x = to_bf16_values(rng.standard_normal((1, 8, 12, cin)))
    k = to_bf16_values(rng.standard_normal((4, 4, cin, cout)) * 0.1)
    b = to_bf16_values(rng.standard_normal(cout) * 0.1)
    g = to_bf16_values(rng.standard_normal((1, 4, 6, cout)))
    for dt in ("float32", "bfloat16"):
        jd = jnp.float32 if dt == "float32" else jnp.bfloat16
        y, vjp = jax.vjp(lambda x_, k_, b_: jax_c4(x_, k_.astype(jd), b_.astype(jd)),
                         jnp.asarray(x, jd), jnp.asarray(k), jnp.asarray(b))
        gx, gk, gb = vjp(jnp.asarray(g, jd))
        td = getattr(torch, dt)
        tx = torch.from_numpy(x).to(td).requires_grad_(True)
        tw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
        tb_ = torch.from_numpy(b).requires_grad_(True)
        ty = conv4x4_stride2(tx, tw.to(td), tb_.to(td))
        ty.backward(torch.from_numpy(g).to(td))
        pairs = [(ty.detach(), y), (tx.grad, gx),
                 (tw.grad.permute(2, 3, 1, 0), gk), (tb_.grad, gb)]
        for a, b_ in pairs:
            a, b_ = a.float().numpy(), np.asarray(b_.astype(jnp.float32))
            if dt == "float32":
                np.testing.assert_allclose(a, b_, rtol=1e-4,
                                           atol=1e-4 * np.abs(b_).max())
            else:
                assert_within_bf16(a, b_, rel_scale=2e-3)


def test_conv4x4_patch_dispatch_matches_jax_phase_conv(rng):
    """D conv1 on the planar map: f32 (library conv) and bf16 (kernel 4's
    plain version) against JAX conv4x4_s2d_phases on the phases of the
    padded map, forward and the weight grad."""
    c, cout, h, w = 19, 64, 8, 12
    x = to_bf16_values(rng.random((1, c, h, w)))
    k = to_bf16_values(rng.standard_normal((4, 4, c, cout)) * 0.1)
    b = to_bf16_values(rng.standard_normal(cout) * 0.1)
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1))).transpose(0, 2, 3, 1)
    phases = tuple(jnp.asarray(xp[:, r::2, s::2]) for r in (0, 1) for s in (0, 1))
    for dt in ("float32", "bfloat16"):
        jd = jnp.float32 if dt == "float32" else jnp.bfloat16
        y, vjp = jax.vjp(
            lambda k_: conv4x4_s2d_phases(tuple(p.astype(jd) for p in phases),
                                          k_.astype(jd), jnp.asarray(b, jd)),
            jnp.asarray(k))
        (gk,) = vjp(jnp.ones_like(y))
        td = getattr(torch, dt)
        tw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
        ty = conv4x4_patch(torch.from_numpy(x).to(td), tw.to(td),
                           torch.from_numpy(b).to(td))
        assert ty.shape == (1, h // 2, w // 2, cout)
        ty.backward(torch.ones_like(ty))
        for a, b_ in ((ty.detach(), y), (tw.grad.permute(2, 3, 1, 0), gk)):
            a, b_ = a.float().numpy(), np.asarray(b_.astype(jnp.float32))
            if dt == "float32":
                np.testing.assert_allclose(a, b_, rtol=1e-4,
                                           atol=1e-4 * np.abs(b_).max())
            else:
                assert_within_bf16(a, b_, rel_scale=2e-3)
