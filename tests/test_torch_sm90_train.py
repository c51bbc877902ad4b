"""The train path's kernels on the Hopper core, on the CPU: kernel 2
(csrc/conv3x3_dil.cu through csrc/igemm_sm90.cuh) and kernel 5's wgrad
(csrc/conv4x4_s2.cu::wgrad_sm90_kernel).

The CUDA kernels run only on the card (chip_smoke.py phase 8 holds them
against the plain versions there). What they are handed is decided in
Python and modelled here: the tile plan shared by kernels 2 and 3, the
dgrad's K-major weights with the taps mirrored in the gather, the wgrad's
pixel split, its stepped pixel decode, and the MN-major 128B-swizzled
shared-memory layout that its gather, its TMA boxes and its wgmma
descriptors must agree on. Tolerances as in tests/test_torch_train_kernels.py:
bf16 outputs one bf16 ulp of the reference plus 1e-3 of the largest
magnitude (the same exact products summed in another order, one rounding);
f32 outputs 1e-4 relative plus 1e-4 of the largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.ops.pallas.conv3x3_dil import conv3x3_dil_mxu
from adaptsegnet_tpu.ops.pallas.conv4x4_s2 import conv4x4_s2_mxu
from adaptsegnet_tpu_torch.ops.kernels import conv3x3_dil as k2
from adaptsegnet_tpu_torch.ops.kernels import conv4x4_s2 as k5
from tests.test_torch_igemm_sm90 import im2col_4x4_s2
from tests.test_torch_train_kernels import (
    as_np,
    assert_bf16_close,
    assert_f32_close,
    bf16_values,
    tb,
)

# (N, H, W, C) of the 3x3 convs each kernel gets on the main paths, with
# the tile and the grid of blocks the plan must give. Kernel 2: the train
# step, one image; kernel 3: the batched eval (the tiles it already had).
TILES = {
    "k2 layer3 N1": ((1, 64, 128, 256), (128, 128), 128),
    "k2 layer4 N1": ((1, 64, 128, 512), (128, 256), 128),
    "k3 layer2 N4": ((4, 64, 128, 128), (128, 128), 256),
    "k3 layer3 N4": ((4, 64, 128, 256), (128, 256), 256),
    "k3 layer4 N4": ((4, 64, 128, 512), (128, 256), 512),
    "k3 Oracle layer3 N2": ((2, 65, 129, 256), (128, 256), 132),
    "k3 Oracle layer4 N2": ((2, 65, 129, 512), (128, 256), 264),
    "k3 layer3 N8": ((8, 64, 128, 256), (128, 256), 512),
}
# Kernel 5's wgrad at D conv2..4 (input H, W, Cin, Cout at 512x1024, batch
# 1), with the split and the pixels per split the plan must give.
D_WGRAD = {"conv2": ((256, 512, 64, 128), (16, 2048)),
           "conv3": ((128, 256, 128, 256), (4, 2048)),
           "conv4": ((64, 128, 256, 512), (1, 2048))}
SMALL_WGRAD = {"16x32 c64": (1, 16, 32, 64, 128), "n2 16x16 c128": (2, 16, 16, 128, 128),
               "12x20 c64": (1, 12, 20, 64, 128), "20x28 c64": (1, 20, 28, 64, 128),
               "n3 10x6 c64 c256": (3, 10, 6, 64, 256)}


@pytest.mark.parametrize("name", list(TILES))
def test_tile_plan_at_the_main_path_shapes(name):
    """128 x 256 only where that grid holds about one wave of blocks: kernel
    2 at one image takes 128 x 128 at layer3 (128 blocks, not 64) and 128 x
    256 at layer4; kernel 3 keeps the tiles it had."""
    (n, h, w, c), tile, blocks = TILES[name]
    m = n * h * w
    assert k2.tile_plan(m, c) == tile
    bm, bn = tile
    assert -(-m // bm) * (c // bn) == blocks


def test_tile_plan_takes_the_wide_tile_from_about_one_wave():
    # cout 512: 2 column tiles, so 59 row tiles hold 118 blocks (< 0.9 * 132)
    assert k2.tile_plan(59 * 128, 512) == (128, 128)
    assert k2.tile_plan(60 * 128, 512) == (128, 256)
    assert k2.tile_plan(10 ** 6, 384) == (128, 128)  # 384 % 256 != 0


def core_model(src, wt, taps_at, d_out_dtype=torch.bfloat16):
    """The Hopper core's implicit GEMM as a numpy model: for each tap t of
    the K-major weights wt (Ncols, taps * Cs) the shifted source pixels
    (zero outside) times that tap's column block, summed in f32, rounded
    once. taps_at[t] = (dy, dx), the source offset of tap t."""
    n, h, w, cs = src.shape
    acc = np.zeros((n, h, w, wt.shape[0]), np.float32)
    pad = max(max(abs(a), abs(b)) for a, b in taps_at)
    sp = np.pad(src, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    for t, (oy, ox) in enumerate(taps_at):
        a = sp[:, pad + oy:pad + oy + h, pad + ox:pad + ox + w, :]
        acc += a @ wt[:, t * cs:(t + 1) * cs].T
    return as_np(torch.from_numpy(acc).to(d_out_dtype))


def taps_3x3(d, flip):
    """The tap offsets of csrc/conv3x3_dil.cu's geometry: tap (ky, kx)
    reads (t * tmul + tadd) with tmul, tadd = (d, -d), or (-d, d) with
    `flip` (the dgrad)."""
    tmul, tadd = (-d, d) if flip else (d, -d)
    return [(ky * tmul + tadd, kx * tmul + tadd) for ky in range(3) for kx in range(3)]


def test_dgrad_weights_with_mirrored_taps_are_the_old_flipped_matrix(rng):
    """The dgrad hands the core kmajor_weights(w.transpose(0, 1)), (Cin,
    9*Cout), one relayout, and mirrors the taps in the gather. Tap t there
    reads the source offset that tap 8 - t of the forward geometry reads,
    and its column block is the old (9*Cout, Cin) matrix of the flipped
    weights' row block 8 - t, transposed (built tap by tap)."""
    cout, cin, d = 24, 64, 2
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)).astype(np.float32))
    wt = k2.kmajor_weights(w.transpose(0, 1))
    assert wt.shape == (cin, 9 * cout)
    wf = k2.flip_weights(w)                               # (Cin, Cout, 3, 3)
    old = torch.cat([wf[:, :, ky, kx].T for ky in range(3) for kx in range(3)])
    assert old.shape == (9 * cout, cin)
    fwd, mirrored = taps_3x3(d, False), taps_3x3(d, True)
    for t in range(9):
        assert mirrored[t] == fwd[8 - t]
        assert torch.equal(wt[:, t * cout:(t + 1) * cout],
                           old[(8 - t) * cout:(9 - t) * cout].T)
    assert torch.equal(k2.kmajor_weights(w), old.new_tensor(
        np.concatenate([w[:, :, ky, kx].numpy() for ky in range(3)
                        for kx in range(3)], 1)))


@pytest.mark.parametrize("cin,cout,d", [(128, 128, 2), (128, 256, 4)])
def test_core_model_of_kernel_2_matches_pallas_and_plain(rng, cin, cout, d):
    """The core as csrc/conv3x3_dil.cu drives it, forward and dgrad (taps
    mirrored, io-swapped K-major weights), against the Pallas kernel in
    interpret mode (the dgrad on the flipped weights,
    adaptsegnet_tpu/ops/conv3x3.py:115-117) and the plain versions."""
    x = bf16_values(rng, (1, 16, 24, cin))
    dy = bf16_values(rng, (1, 16, 24, cout))
    k = bf16_values(rng, (3, 3, cin, cout), 0.05)        # HWIO
    w = tb(k.transpose(3, 2, 0, 1))                       # OIHW
    got = core_model(x, k2.kmajor_weights(w).float().numpy(), taps_3x3(d, False))
    ref = conv3x3_dil_mxu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                          d, interpret=True)
    assert_bf16_close(got, np.asarray(ref.astype(jnp.float32)))
    assert_bf16_close(got, as_np(k2.conv3x3_dil_plain(tb(x), w, d)))

    got_dx = core_model(dy, k2.kmajor_weights(w.transpose(0, 1)).float().numpy(),
                        taps_3x3(d, True))
    kf = jnp.flip(jnp.asarray(k, jnp.bfloat16), axis=(0, 1)).transpose(0, 1, 3, 2)
    ref_dx = conv3x3_dil_mxu(jnp.asarray(dy, jnp.bfloat16), kf, d, interpret=True)
    assert got_dx.shape == (1, 16, 24, cin)
    assert_bf16_close(got_dx, np.asarray(ref_dx.astype(jnp.float32)))
    assert_bf16_close(got_dx, as_np(k2.conv3x3_dil_dgrad(tb(dy), w, d)))


def wgrad_dims(h, w, cin, cout, n=1):
    """(pixels, dW rows, Cout) of the wgrad's GEMM."""
    return n * (h // 2) * (w // 2), 16 * cin, cout


def pixel_ranges(m, splits, per):
    """The K steps (64 pixels each) of each split, as the kernel walks
    them: split s starts at pixel s * per and stops at the end of its range
    or at m, its last step zero-filled past m."""
    return [list(range(s * per // k5.BK, -(-min(m, s * per + per) // k5.BK)))
            for s in range(splits)]


@pytest.mark.parametrize("name", list(D_WGRAD) + list(SMALL_WGRAD))
def test_wgrad_plan_covers_every_k_step_once(name):
    """per is a whole number of K steps; the ranges are non-empty and
    together hold every K step once; the tiles alone fill the card (>= 132)
    with splits == 1; otherwise tiles x splits stays within one wave."""
    if name in D_WGRAD:
        m, rows, cout = wgrad_dims(*D_WGRAD[name][0])
    else:
        n, h, w, cin, cout = SMALL_WGRAD[name]
        m, rows, cout = wgrad_dims(h, w, cin, cout, n)
    splits, per = k5.wgrad_plan(m, rows, cout)
    assert per % k5.BK == 0 and splits >= 1
    ranges = pixel_ranges(m, splits, per)
    assert all(ranges)
    assert [s for r in ranges for s in r] == list(range(-(-m // k5.BK)))
    tiles = (rows // k5.BM) * (cout // k5.BN)
    if tiles >= k5.SMS:
        assert splits == 1
    if splits > 1:
        assert tiles * splits <= k5.SMS


@pytest.mark.parametrize("name", list(D_WGRAD))
def test_wgrad_plan_at_d_conv2_to_4(name):
    """conv2 (8 tiles) splits 16 ways, conv3 (32 tiles) 4 ways, conv4 (128
    tiles) not at all: at most 8.4 MB of f32 partials, none at conv4, where
    1,024 pixels per split wrote 16.8 MB at every shape."""
    shape, plan = D_WGRAD[name]
    m, rows, cout = wgrad_dims(*shape)
    splits, per = k5.wgrad_plan(m, rows, cout)
    assert (splits, per) == plan
    partial_bytes = 4 * splits * rows * cout if splits > 1 else 0
    assert partial_bytes <= 8.4e6
    assert (partial_bytes == 0) == (name == "conv4")


def stepped_decode(p0, k0, ho, wo, steps):
    """The wgrad producer's pixel walk (csrc/conv4x4_s2.cu): pixel p0 + k0 +
    16 i decoded once, then stepped by 64 per stage with carries into the
    row and the image. Yields (stage, i, p, (n, row, column))."""
    pm, pj, pi, pn = [], [], [], []
    for i in range(4):
        p = p0 + k0 + 16 * i
        t = p // wo
        pm.append(p)
        pj.append(p % wo)
        pi.append(t % ho)
        pn.append(t // ho)
    for it in range(steps):
        for i in range(4):
            yield it, i, pm[i], (pn[i], pi[i], pj[i])
            pm[i] += k5.BK
            pj[i] += k5.BK
            while pj[i] >= wo:
                pj[i] -= wo
                pi[i] += 1
                if pi[i] == ho:
                    pi[i] = 0
                    pn[i] += 1


@pytest.mark.parametrize("ho,wo", [(128, 256), (3, 5), (8, 64), (7, 100)])
def test_wgrad_stepped_pixel_decode_is_divmod(ho, wo):
    for p0 in (0, 2048):
        for k0 in (0, 7, 15):
            for _, i, p, got in stepped_decode(p0, k0, ho, wo, 12):
                assert p == p0 + k0 + 16 * i + 64 * _
                assert got == (p // (ho * wo), p // wo % ho, p % wo)


def gather_offset(k, mn):
    """The byte offset in a stage at which the wgrad's gather (A) and its
    TMA boxes (B) put element (K row k, column mn) of a 64 x 128 operand
    tile: the 64-column half at mn // 64 * 8,192 bytes, K row k at k * 128,
    its 16-byte chunk c = mn % 64 // 8 at chunk c ^ (k % 8)."""
    return ((mn // 64) * 8192 + k * 128 + (((mn % 64) // 8) ^ (k % 8)) * 16
            + (mn % 8) * 2)


def descriptor_offset(kk, k, mn, lbo=8192, sbo=1024):
    """Where the wgmma of K step kk (16 K rows) reads element (k, mn), k in
    [16 kk, 16 kk + 16), from the descriptor desc_mn_sw128(base + 2,048 kk,
    lbo): CUTLASS's MN-major SW128 layout ((8, 8, m), (8, k)) : ((1, 8,
    LBO), (64, SBO)) in elements, then the 128B swizzle of the address
    (bits 4-6 XOR bits 7-9; the atoms are 1,024-aligned)."""
    kr = k - 16 * kk
    assert 0 <= kr < 16
    lin = (2048 * kk + (mn // 64) * lbo + (kr // 8) * sbo + (kr % 8) * 128
           + (mn % 64) * 2)
    return lin ^ (((lin >> 7) & 7) << 4)


@pytest.mark.parametrize("cols", [64, 128], ids=["A half (M 64)", "B (N 128)"])
def test_mn_major_swizzle_gather_and_descriptor_agree(cols):
    """Every element of a stage lies where the descriptor reads it, and the
    tile's elements fill 2-byte slots of the stage once each."""
    ks, mns = np.meshgrid(np.arange(64), np.arange(cols), indexing="ij")
    got = np.vectorize(gather_offset)(ks, mns)
    want = np.vectorize(descriptor_offset)(ks // 16, ks, mns)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == got.size and got.max() < cols * 128
    assert not (got % 2).any()
    # the TMA box of 64 channels x 64 pixels with SWIZZLE_128B: row k of
    # the box at k * 128, its chunk c at c ^ (k % 8), the same slots
    tma = (mns // 64) * 8192 + ks * 128 + (((mns % 64) // 8) ^ (ks % 8)) * 16 + (mns % 8) * 2
    np.testing.assert_array_equal(got, tma)


def split_wgrad_model(x, dy):
    """The wgrad as csrc/conv4x4_s2.cu computes it: dW rows (ky*4 + kx)*Cin
    + ci, the pixels cut by the plan into K steps of 64 (zero past m),
    per-split f32 partials, summed in split order."""
    n, h, w, cin = x.shape
    cout = dy.shape[-1]
    a = im2col_4x4_s2(x)                                   # (m, 16*Cin)
    b = dy.reshape(-1, cout)
    m = a.shape[0]
    splits, per = k5.wgrad_plan(m, 16 * cin, cout)
    partials = []
    for steps in pixel_ranges(m, splits, per):
        part = np.zeros((16 * cin, cout), np.float32)
        for kt in steps:
            ks = slice(kt * k5.BK, min(m, kt * k5.BK + k5.BK))
            part += a[ks].T @ b[ks]
        partials.append(part)
    acc = np.zeros_like(partials[0])
    for p in partials:
        acc = acc + p
    return acc.reshape(4, 4, cin, cout), splits


@pytest.mark.parametrize("name", list(SMALL_WGRAD))
def test_split_wgrad_model_matches_pallas_and_plain(rng, name):
    """The split wgrad's model against dW of conv4x4_s2_mxu's VJP in
    interpret mode (the Pallas `_wgrad_impl`) and against the plain
    version, in f32 (HWIO against the Pallas dW, OIHW against the plain)."""
    n, h, w, cin, cout = SMALL_WGRAD[name]
    x = bf16_values(rng, (n, h, w, cin))
    k = bf16_values(rng, (4, 4, cin, cout), 0.05)
    b = bf16_values(rng, (cout,), 0.5)
    dy = bf16_values(rng, (n, h // 2, w // 2, cout))
    got, splits = split_wgrad_model(x, dy)
    if name in ("16x32 c64", "n2 16x16 c128", "20x28 c64"):
        assert splits > 1
    _, vjp = jax.vjp(lambda x_, k_, b_: conv4x4_s2_mxu(x_, k_, b_, True),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b))
    _, gk, _ = vjp(jnp.asarray(dy, jnp.bfloat16))
    assert_f32_close(got, np.asarray(gk))
    plain = k5.conv4x4_s2_wgrad_plain(tb(x), tb(dy))
    assert plain.shape == (cout, cin, 4, 4)
    assert_f32_close(got.transpose(3, 2, 0, 1), plain.numpy())
