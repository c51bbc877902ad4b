"""The Hopper implicit-GEMM core's host-side contract (csrc/igemm_sm90.cuh),
on the CPU: kernel 5's split-K plan, a numpy model of the split-K forward
against the JAX Pallas kernel and the plain version, and the K-major weight
matrices the core reads.

The CUDA core runs only on the card (chip_smoke.py phase 8 holds it against
the plain versions there). What it is handed is decided here, in Python:
the plan (`fwd_plan`: row tile, K ranges, K steps per range) and the weight
relayouts. Tolerance of the model: one bf16 ulp of the reference plus 1e-3
of the largest magnitude (tests/test_torch_train_kernels.py), since the
model sums the same exact products in another order and rounds once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptsegnet_tpu.ops.pallas.conv4x4_s2 import conv4x4_s2_mxu
from adaptsegnet_tpu_torch.ops.kernels import conv3x3_dil as k3
from adaptsegnet_tpu_torch.ops.kernels import conv4x4_s2 as k5
from tests.test_torch_train_kernels import as_np, assert_bf16_close, bf16_values, tb

# Kernel 5's forward shapes in chip_smoke.py phase 8: (input H, W, Cin, Cout)
# of D conv2..4 and the Warper encoder's down1..out at 512x1024, batch 1.
D_CONVS = {"conv2": (256, 512, 64, 128), "conv3": (128, 256, 128, 256),
           "conv4": (64, 128, 256, 512)}
ENCODER = {"down1": (256, 512, 64, 128), "down2": (128, 256, 128, 256),
           "down3": (64, 128, 256, 512), "down4": (32, 64, 512, 512),
           "down5": (16, 32, 512, 512), "down6": (8, 16, 512, 512),
           "out": (4, 8, 512, 512)}
PHASE8 = {**D_CONVS, **ENCODER}
SMALL = {"small a": (8, 16, 128, 128), "small b": (4, 8, 128, 128),
         "small c": (16, 16, 64, 128), "small d": (30, 34, 64, 256)}


def gemm_dims(h, w, cin, cout, n=1):
    return n * (h // 2) * (w // 2), 16 * cin, cout


def k_ranges(plan, k):
    bm, splits, per = plan
    steps = k // k5.BK
    return [range(s * per, min(steps, s * per + per)) for s in range(splits)]


@pytest.mark.parametrize("name", list(PHASE8) + list(SMALL))
def test_fwd_plan_covers_every_k_step_once(name):
    """Each range is a whole number of K steps, none is empty, together
    they cover every step once; the row tile is one wgmma M (64) only where
    M fits it; splits is 1 wherever the tiles fill the card, and a split
    launch has >= SMS blocks unless each range is one K step."""
    m, k, cout = gemm_dims(*{**PHASE8, **SMALL}[name])
    plan = k5.fwd_plan(m, k, cout)
    bm, splits, per = plan
    assert k % k5.BK == 0 and bm == (64 if m <= 64 else 128)
    ranges = k_ranges(plan, k)
    assert all(len(r) >= 1 for r in ranges)
    steps = [s for r in ranges for s in r]
    assert steps == list(range(k // k5.BK))
    tiles = -(-m // bm) * -(-cout // k5.BN)
    if tiles >= k5.SMS:
        assert splits == 1
    if splits > 1:  # as many blocks as the card has SMs, or one step each
        assert tiles * splits >= k5.SMS or per == 1


def test_fwd_plan_at_the_main_path_shapes():
    """D conv2, conv3 and the encoder's down1, down2 fill the card (256 or
    128 tiles) and keep one range; conv4 and down3 (64 tiles) and
    down4..out (4-16 tiles) split K into >= 132 blocks."""
    blocks = {}
    for name, shape in PHASE8.items():
        m, k, cout = gemm_dims(*shape)
        bm, splits, per = k5.fwd_plan(m, k, cout)
        blocks[name] = (splits, -(-m // bm) * -(-cout // k5.BN) * splits)
    for name in ("conv2", "conv3", "down1", "down2"):
        assert blocks[name][0] == 1, (name, blocks[name])
    for name in ("conv4", "down3", "down4", "down5", "down6", "out"):
        assert blocks[name][0] > 1 and blocks[name][1] >= k5.SMS, (name, blocks[name])


def im2col_4x4_s2(x):
    """(N, H, W, C) f32 -> (N*H/2*W/2, 16*C): row (n, i, j), column
    (ky*4 + kx)*C + c holding x[n, 2i + ky - 1, 2j + kx - 1, c] (zero
    outside), the A matrix the core gathers."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = [xp[:, ky:ky + h:2, kx:kx + w:2, :] for ky in range(4) for kx in range(4)]
    return np.concatenate(cols, -1).reshape(n * (h // 2) * (w // 2), 16 * c)


def split_k_model(x, w, b):
    """The split-K forward as the core and csrc/splitk.cuh compute it: f32
    partials over the plan's K ranges, summed in split order, the f32 bias
    added, one rounding to bf16."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    a = im2col_4x4_s2(x)
    bt = k5.kmajor_weights(torch.from_numpy(w)).numpy()     # (Cout, K)
    plan = k5.fwd_plan(a.shape[0], a.shape[1], cout)
    partials = []
    for r in k_ranges(plan, a.shape[1]):
        ks = slice(r.start * k5.BK, r.stop * k5.BK)
        partials.append((a[:, ks] @ bt[:, ks].T).astype(np.float32))
    acc = np.zeros_like(partials[0])
    for p in partials:
        acc = acc + p
    if b is not None:
        acc = acc + b.astype(np.float32)
    out = torch.from_numpy(acc).to(torch.bfloat16).reshape(n, h // 2, wd // 2, cout)
    return out, plan


@pytest.mark.parametrize("shape", [(1, 8, 16, 128, 128), (1, 4, 8, 128, 128),
                                   (2, 8, 8, 64, 128)],
                         ids=["8x16", "4x8", "n2_8x8"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_split_k_model_matches_pallas_and_plain(rng, shape, with_bias):
    """A deep-encoder geometry cut to a small width: the plan splits K, and
    the model of the split-K forward agrees with the Pallas kernel in
    interpret mode and with the plain version."""
    n, h, w, cin, cout = shape
    x = bf16_values(rng, (n, h, w, cin))
    k = bf16_values(rng, (4, 4, cin, cout), 0.05)              # HWIO
    wt = np.ascontiguousarray(k.transpose(3, 2, 0, 1))        # OIHW
    b = bf16_values(rng, (cout,), 0.5) if with_bias else None
    got, plan = split_k_model(x, wt, b)
    assert plan[1] > 1
    bias = jnp.asarray(b if with_bias else np.zeros(cout, np.float32))
    ref = conv4x4_s2_mxu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), bias, True)
    assert_bf16_close(as_np(got), np.asarray(ref.astype(jnp.float32)))
    plain = k5.conv4x4_s2_fwd_plain(tb(x), tb(wt), None if b is None else tb(b))
    assert_bf16_close(as_np(got), as_np(plain))


def test_kmajor_weights_are_the_old_matrices_transposed(rng):
    """The Hopper core's K-major weights against the (K, Cout) matrices the
    wmma core reads (kernel 2's layout, kernel 5's before)."""
    w3 = torch.from_numpy(rng.standard_normal((32, 64, 3, 3)).astype(np.float32))
    old3 = w3.permute(2, 3, 1, 0).reshape(9 * 64, 32)
    assert torch.equal(k3.kmajor_weights(w3), old3.T)
    w5 = torch.from_numpy(rng.standard_normal((24, 64, 4, 4)).astype(np.float32))
    old5 = w5.permute(2, 3, 1, 0).reshape(16 * 64, 24)
    assert torch.equal(k5.kmajor_weights(w5), old5.T)
    np.testing.assert_array_equal(
        k5.kmajor_weights(w5)[5, (2 * 4 + 3) * 64 + 7].item(), w5[5, 7, 2, 3].item())
    # the wmma core's dgrad matrices, (4, 4*Cout, Cin), row block 2a + b
    w6 = w5.reshape(24, 64, 2, 2, 2, 2).permute(3, 5, 2, 4, 0, 1).flip(0, 1)
    old = w6.reshape(4, 4 * 24, 64)
    kmaj = k5.dgrad_weights(w5)                               # (4, Cin, 4*Cout)
    assert kmaj.shape == (4, 64, 4 * 24) and kmaj.is_contiguous()
    for z in range(4):
        assert torch.equal(kmaj[z], old[z].T)
    py, px, a, bb, co, ci = 1, 0, 1, 1, 9, 40
    assert kmaj[2 * py + px, ci, (2 * a + bb) * 24 + co].item() == \
        w5[co, ci, 1 - py + 2 * a, 1 - px + 2 * bb].item()


@pytest.mark.parametrize("name", list(PHASE8))
def test_every_k_step_lies_in_one_tap(name):
    """The core gathers one 64-channel K step per stage from one source
    pixel per row: every K step of every phase-8 shape lies within one tap
    (Cin is a multiple of 64), for the forward (K = 16*Cin) and the dgrad
    (K = 4*Cout over Cout channels)."""
    h, w, cin, cout = PHASE8[name]
    for cs, taps in ((cin, 16), (cout, 4)):
        assert cs % k5.BK == 0
        for kt in range(taps * cs // k5.BK):
            first, last = kt * k5.BK, kt * k5.BK + k5.BK - 1
            assert first // cs == last // cs
