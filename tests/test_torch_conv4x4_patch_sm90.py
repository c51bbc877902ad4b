"""Kernel 4 on the Hopper core's pieces, on the CPU (csrc/conv4x4_patch.cu).

The CUDA kernels run only on the card (chip_smoke.py phase 8 holds them
against the plain versions there). What they compute is modelled here in
numpy, down to the bits: the planar patch producer (map rows staged as
TMA boxes or 4-byte copies, zero outside the map and past C, three words
per map row assembled into one 16-byte chunk, written at chunk q ^ (m % 8)
of row m; the segments stepped without a division), the forward's implicit
GEMM over row segments of 128 pixels, the dgrad's parity classes (K = 4
taps x 64, no zero tap) with its planar epilogue, and the wgrad's pixel
split. The models are held against
`conv4x4_s2_phases_planar(..., interpret=True)` and its VJP. Tolerances: bf16
outputs one bf16 ulp of the reference plus 1e-3 of the largest magnitude
(the same exact products summed in another order, one rounding); the f32
wgrad 1e-4 of the largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.ops.pallas.conv4x4_patch import conv4x4_s2_phases_planar
from adaptsegnet_tpu_torch.ops.kernels import conv4x4_patch as k4
from adaptsegnet_tpu_torch.ops.kernels import conv4x4_s2 as k5
from tests.test_torch_train_kernels import (
    _dense_from_phases,
    _planar_phases,
    as_np,
    assert_bf16_close,
    tb,
)

C, COUT = 19, 64
P_FWD, P_WG, Q_DG = 128, 64, 64  # pixels per forward tile, wgrad K step, dgrad q-columns
THREADS = 256                    # the producer's two warpgroups


def softmax_map(rng, n, h, w):
    """(N, 19, H, W) bf16-representable softmax map, as the D input."""
    x = jax.nn.softmax(rng.standard_normal((n, C, h, w)), axis=1)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def bf16_of(rng, shape, scale):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def bits(a):
    """bf16 bit patterns (uint16) of bf16-representable f32 values."""
    return (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def from_bits(b):
    return (b.astype(np.uint32) << 16).view(np.float32)


def segments(n, h, w, p):
    """The kernels' row segments: (image, output row, first column, count),
    per_row = ceil(Wo / p) per output row, the last masked."""
    ho, wo = h // 2, w // 2
    per_row = -(-wo // p)
    out = []
    for sg in range(n * ho * per_row):
        row, jt = divmod(sg, per_row)
        nn, i = divmod(row, ho)
        out.append((nn, i, jt * p, min(p, wo - jt * p)))
    return out


def unit_layout(p):
    """Unit<P>: P + 8 words per staged row, in one TMA box per at most 256
    map columns: (words, boxes, words per box, bytes per box)."""
    words = p + 8
    boxes = 2 if 2 * words > 256 else 1
    bw = words // boxes
    return words, boxes, bw, 16 * bw * 4


def raw_offset(rr, u, p):
    """Unit<P>::offset: word u of staged row rr at box u // bw, row rr."""
    _, _, bw, bb = unit_layout(p)
    return (u // bw) * bb + (rr * bw + u % bw) * 4


def stage_rows(xb, seg, g, p):
    """The unit's staged map rows, as bytes of its raw slot: row rr =
    channel 4g + rr // 4 at map row 2i - 1 + rr % 4, word u = map columns
    2j0 - 8 + 2u (low half) and + 1 (high half) at raw_offset(rr, u); zero
    outside the map and for channels >= C."""
    n, c, h, w = xb.shape
    nn, i, j0, _ = seg
    words, boxes, _, bb = unit_layout(p)
    raw = np.zeros(boxes * bb // 4, np.uint32)
    for rr in range(16):
        ch, y = 4 * g + rr // 4, 2 * i - 1 + rr % 4
        if ch >= c or not 0 <= y < h:
            continue
        for u in range(words):
            col = 2 * j0 - 8 + 2 * u
            if 0 <= col < w:
                raw[raw_offset(rr, u, p) // 4] = (int(xb[nn, ch, y, col])
                                                  | int(xb[nn, ch, y, col + 1]) << 16)
    return raw


def byte_perm_5432(a, b):
    """__byte_perm(a, b, 0x5432): a's high half, then b's low half."""
    return (a >> 16) | ((b & 0xFFFF) << 16)


def build_rows(raw, cnt, p):
    """build_rows: the unit's p x 128-byte swizzled K chunk, each producer
    thread writing row tid % p, chunks (tid // p) * 8p/THREADS onwards, from
    words m + 3 .. m + 5 of two staged rows. Returns the bytes and the
    (row, chunk) each thread wrote."""
    buf = np.zeros(p * 128, np.uint8)
    wrote = []
    kq = p * 8 // THREADS
    for tid in range(THREADS):
        m, q0 = tid % p, (tid // p) * kq
        for q in range(q0, q0 + kq):
            row = (q >> 1) * 4 + (q & 1) * 2
            r0, r1 = ([int(raw[raw_offset(row + r, m + 3 + d, p) // 4]) for d in range(3)]
                      for r in range(2))
            v = np.array([byte_perm_5432(r0[0], r0[1]), byte_perm_5432(r0[1], r0[2]),
                          byte_perm_5432(r1[0], r1[1]), byte_perm_5432(r1[1], r1[2])],
                         np.uint32)
            if m >= cnt:
                v[:] = 0
            off = m * 128 + ((q ^ (m & 7)) << 4)
            buf[off:off + 16] = v.view(np.uint8)
            wrote.append((m, q))
    return buf, wrote


def kmajor_read(buf, rows):
    """The (rows, 64) bf16 matrix that a K-major SW128 wgmma descriptor
    reads: element (r, k) at r * 128 + ((k // 8) ^ (r % 8)) * 16 + (k % 8) * 2."""
    r, k = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    off = r * 128 + (((k // 8) ^ (r % 8)) << 4) + (k % 8) * 2
    return from_bits(buf.view(np.uint16)[off // 2])


def mn_major_read(buf, kdim):
    """The (64, kdim) matrix an MN-major SW128 descriptor (one 64-wide MN
    block, 8-row K atoms of 1,024 bytes) reads: element (mn, k) at the
    swizzle of k * 128 + mn * 2 (tests/test_torch_sm90_train.py)."""
    mn, k = np.meshgrid(np.arange(64), np.arange(kdim), indexing="ij")
    lin = k * 128 + mn * 2
    off = lin ^ (((lin >> 7) & 7) << 4)
    return from_bits(buf.view(np.uint16)[off // 2])


def patch_rows(x, seg, p):
    """The producer's (p, 320) patch rows of one segment: the five units'
    chunks read back as K-major rows."""
    xb = bits(x)
    return np.concatenate([kmajor_read(build_rows(stage_rows(xb, seg, g, p), seg[3], p)[0], p)
                           for g in range(5)], 1)


def direct_patch(x, seg, p):
    """The same rows from the definition: (m, k = c*16 + ky*4 + kx) holds
    x[n, c, 2i + ky - 1, 2j + kx - 1], zero outside the map, for c >= C and
    for pixels m >= cnt."""
    n, c, h, w = x.shape
    nn, i, j0, cnt = seg
    out = np.zeros((p, 320), np.float32)
    for m in range(cnt):
        for ch in range(c):
            for ky in range(4):
                for kx in range(4):
                    y, xx = 2 * i + ky - 1, 2 * (j0 + m) + kx - 1
                    if 0 <= y < h and 0 <= xx < w:
                        out[m, ch * 16 + ky * 4 + kx] = x[nn, ch, y, xx]
    return out


def forward_model(x, w, b):
    """fwd_kernel: per row segment of 128 pixels, the producer's rows @ the
    K-major weights (TMA's zero fill past 16*C), f32 sums, bias, one
    rounding, rows m < cnt stored NHWC."""
    n, c, h, wd = x.shape
    wt = np.zeros((COUT, 320), np.float32)
    wt[:, :16 * c] = k4.kmajor_weights(torch.from_numpy(w)).numpy()
    out = np.full((n, h // 2, wd // 2, COUT), np.nan, np.float32)
    for seg in segments(n, h, wd, P_FWD):
        nn, i, j0, cnt = seg
        acc = patch_rows(x, seg, P_FWD) @ wt.T + b
        out[nn, i, j0:j0 + cnt] = acc[:cnt]
    return as_np(torch.from_numpy(out).to(torch.bfloat16))


def pallas_planar(x, k, b, dy):
    """The Pallas kernel in interpret mode: forward, and the VJP's dense dx
    and dW (HWIO)."""
    h, w = x.shape[2:]
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    phases = tuple(q.astype(jnp.bfloat16) for q in _planar_phases(xp))
    y, vjp = jax.vjp(lambda ps, k_, b_: conv4x4_s2_phases_planar(ps, k_, b_, True),
                     phases, jnp.asarray(k), jnp.asarray(b))
    dphases, gk, _ = vjp(jnp.asarray(dy, jnp.bfloat16))
    return (np.asarray(y.astype(jnp.float32)), _dense_from_phases(dphases, h, w),
            np.asarray(gk, np.float32))


def operands(rng, n, h, w):
    x = softmax_map(rng, n, h, w)
    k = bf16_of(rng, (4, 4, C, COUT), 0.05)          # HWIO
    b = bf16_of(rng, (COUT,), 0.5)
    dy = bf16_of(rng, (n, h // 2, w // 2, COUT), 1.0)
    return x, k, b, dy, k.transpose(3, 2, 0, 1).copy()  # OIHW


# ----------------------------------------------------- (a) the producer


@pytest.mark.parametrize("p", [P_FWD, P_WG])
def test_producer_threads_write_every_chunk_once(p):
    """The 256 producer threads write each 16-byte chunk of the unit's p
    rows once, filling the p x 128 bytes."""
    _, boxes, _, bb = unit_layout(p)
    _, wrote = build_rows(np.zeros(boxes * bb // 4, np.uint32), p, p)
    assert sorted(wrote) == [(m, q) for m in range(p) for q in range(8)]
    offs = [m * 128 + ((q ^ (m & 7)) << 4) for m, q in wrote]
    assert len(set(offs)) == p * 8 and max(offs) + 16 == p * 128


@pytest.mark.parametrize("p", [P_FWD, P_WG])
def test_staging_fills_each_staged_word_once(p):
    """Both ways of staging a unit land word u of staged row rr at
    raw_offset(rr, u), each slot byte once: the TMA boxes (16 rows of a
    row-major box each, box b from map column 2j0 - 8 + 2 b bw; a box row
    is at most 256 columns and a multiple of 16 bytes, a slot a multiple of
    128 bytes) and the 4-byte cp.async copies of the producer threads."""
    words, boxes, bw, bb = unit_layout(p)
    assert 2 * bw <= 256 and (2 * bw * 2) % 16 == 0 and (boxes * bb) % 128 == 0
    tma = np.zeros(boxes * bb // 4, int)
    for b in range(boxes):
        for rr in range(16):
            for k in range(bw):   # box b, row rr, word k: map column 2j0 - 8 + 2 (b bw + k)
                assert b * bb + (rr * bw + k) * 4 == raw_offset(rr, b * bw + k, p)
                tma[raw_offset(rr, b * bw + k, p) // 4] += 1
    assert (tma == 1).all()
    copies = np.zeros_like(tma)
    for tid in range(THREADS):
        for idx in range(tid, 16 * words, THREADS):
            rr, u = divmod(idx, words)
            copies[raw_offset(rr, u, p) // 4] += 1
    assert (copies == 1).all()


def seg_walk(sg0, stride, ho, wo, p, steps):
    """SegWalk: segment sg0 decoded once, then stepped by `stride` segments
    with carries into the row and the image, no division."""
    per_row = -(-wo // p)
    dj, drow = stride % per_row, stride // per_row
    row = sg0 // per_row
    jt, n, i = sg0 - row * per_row, row // ho, row % ho
    for _ in range(steps):
        yield n, i, jt * p, min(p, wo - jt * p)
        jt += dj
        rows = drow
        if jt >= per_row:
            jt -= per_row
            rows += 1
        i += rows
        while i >= ho:
            i -= ho
            n += 1


@pytest.mark.parametrize("n,h,w,p,stride", [(1, 512, 1024, P_FWD, 132), (2, 8, 264, P_FWD, 5),
                                            (1, 512, 1024, P_WG, 1), (3, 6, 140, P_WG, 7),
                                            (2, 16, 24, P_FWD, 1)])
def test_segment_walk_is_the_decode(n, h, w, p, stride):
    """The producer's and the forward consumer's stepped segments are the
    kernels' row segments sg0, sg0 + stride, ... (the forward's persistent
    blocks step by the grid, the wgrad's by one)."""
    segs = segments(n, h, w, p)
    for sg0 in range(min(stride, len(segs))):
        want = segs[sg0::stride]
        assert list(seg_walk(sg0, stride, h // 2, w // 2, p, len(want))) == want


@pytest.mark.parametrize("shape,p", [((1, 16, 24), P_FWD), ((1, 8, 264), P_FWD),
                                     ((1, 8, 264), P_WG), ((2, 6, 10), P_WG)],
                         ids=["fwd 16x24", "fwd 8x264", "wgrad 8x264", "wgrad n2 6x10"])
def test_producer_rows_are_the_patch(rng, shape, p):
    """Every (pixel, k) of every unit: the staged words and the byte_perm
    give x at (2i + ky - 1, 2j + kx - 1), or zero (padding, c >= C, masked
    pixels), at the address the K-major descriptor reads (the forward's A)
    and, transposed, the MN-major one (the wgrad's operand for K = pixel)."""
    n, h, w = shape
    x = softmax_map(rng, n, h, w)
    xb = bits(x)
    for seg in segments(n, h, w, p):
        np.testing.assert_array_equal(patch_rows(x, seg, p), direct_patch(x, seg, p))
        buf, _ = build_rows(stage_rows(xb, seg, 4, p), seg[3], p)
        np.testing.assert_array_equal(mn_major_read(buf, p), kmajor_read(buf, p).T)


def test_segments_mask_the_last_tile_of_a_row():
    segs = segments(1, 8, 264, P_FWD)   # Wo = 132: 128 + a masked tile of 4
    assert [s[2:] for s in segs[:2]] == [(0, 128), (128, 4)] and len(segs) == 8
    assert segments(1, 1024, 2048, P_FWD)[-1] == (0, 511, 896, 128)


@pytest.mark.parametrize("shape", [(1, 16, 24), (1, 8, 264)], ids=["16x24", "8x264"])
def test_forward_model_matches_pallas_and_plain(rng, shape):
    n, h, w = shape
    x, k, b, dy, w_oihw = operands(rng, n, h, w)
    got = forward_model(x, w_oihw, b)
    y, _, _ = pallas_planar(x, k, b, dy)
    assert_bf16_close(got, y)
    assert_bf16_close(got, as_np(k4.conv4x4_patch_fwd_plain(tb(x), tb(w_oihw), tb(b))))


# -------------------------------------------------------- (b) the dgrad


def dgrad_gather_source(tile, r0, i, b):
    """The dgrad producer's source column of row r0 + 16 i of a stage at tap
    column b: rows 0-63 column parity 0, rows 64-127 parity 1."""
    return tile + r0 + 16 * (i & 3) + (i >> 2) - b


def test_dgrad_gather_rows_are_the_parity_halves():
    for r0 in range(16):
        for i in range(8):
            r = r0 + 16 * i
            for b in (0, 1):
                assert dgrad_gather_source(0, r0, i, b) == r % 64 + r // 64 - b
                assert (r & 7) == (r0 & 7)


def dgrad_model(dy, w_oihw, h, w):
    """dgrad_kernel: per tile (n, y, q0) and column parity px, sum over taps
    t = 2a + b of the gathered dy rows (p + py - a, q + px - b; zero
    outside) @ class (py, px)'s K step t (its 32 rows: C, then zeros), f32,
    staged per channel and rounded once into the planar dx."""
    n, ho, wo, cout = dy.shape
    wt = k5.dgrad_weights(torch.from_numpy(w_oihw)).numpy()   # (4, C, 256)
    b32 = np.zeros((4, 32, 4 * cout), np.float32)
    b32[:, :C] = wt
    dx = np.full((n, C, h, w), np.nan, np.float32)
    per_row = -(-wo // Q_DG)
    for tile in range(n * h * per_row):
        row, qt = divmod(tile, per_row)
        nn, y = divmod(row, h)
        q0, p, py = qt * Q_DG, y >> 1, y & 1
        stage = np.zeros((128, 32), np.float32)
        for t in range(4):
            a, b = t >> 1, t & 1
            rows = np.zeros((128, cout), np.float32)
            for r in range(128):
                sy, sx = p + py - a, q0 + r % 64 + r // 64 - b
                if 0 <= sy < ho and 0 <= sx < wo:
                    rows[r] = dy[nn, sy, sx]
            for px in (0, 1):
                cls = 2 * py + px
                stage[64 * px:64 * px + 64] += (
                    rows[64 * px:64 * px + 64] @ b32[cls, :, 64 * t:64 * t + 64].T)
        for xp in range(min(Q_DG, wo - q0)):
            for px in (0, 1):
                dx[nn, :, y, 2 * (q0 + xp) + px] = stage[64 * px + xp, :C]
    return as_np(torch.from_numpy(dx).to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(1, 16, 24), (2, 6, 140)], ids=["16x24", "n2 6x140"])
def test_dgrad_model_matches_pallas_and_plain(rng, shape):
    """K = 256 with no zero tap against the Pallas VJP's dense dx (the
    phase cotangents at the interior positions); 6x140 masks the second
    64-column tile of each row."""
    n, h, w = shape
    x, k, b, dy, w_oihw = operands(rng, n, h, w)
    got = dgrad_model(dy, w_oihw, h, w)
    _, dx, _ = pallas_planar(x, k, b, dy)
    assert_bf16_close(got, dx)
    assert_bf16_close(got, as_np(k4.conv4x4_patch_dgrad_plain(tb(dy), tb(w_oihw), (h, w))))


# -------------------------------------------------------- (c) the wgrad


WGRAD_PLANS = {  # input (N, H, W) -> (splits, per)
    "main 512x1024": ((1, 512, 1024), (128, 16)),
    "16x24": ((1, 16, 24), (8, 1)),
    "8x264": ((1, 8, 264), (12, 1)),
    "280x16": ((1, 280, 16), (70, 2)),
    "n2 6x140": ((2, 6, 140), (12, 1)),
}


def wgrad_ranges(steps, splits, per):
    return [list(range(s * per, min(steps, s * per + per))) for s in range(splits)]


@pytest.mark.parametrize("name", list(WGRAD_PLANS))
def test_wgrad_plan_covers_every_step_once(name):
    """One block per split holds all 16*C x 64 of dW, so splits alone fill
    at most one wave; every K step (row segment) lies in one range, none
    empty. At 512x1024 the partials are 128 x 304 x 64 f32 (10.0 MB)."""
    (n, h, w), plan = WGRAD_PLANS[name]
    splits, per = k4.wgrad_plan(n, h, w)
    assert (splits, per) == plan and splits <= k4.SMS
    steps = len(segments(n, h, w, P_WG))
    ranges = wgrad_ranges(steps, splits, per)
    assert all(ranges) and [t for r in ranges for t in r] == list(range(steps))


def wgrad_model(x, dy):
    """wgrad_kernel: per split, per K step (a row segment of 64 pixels) the
    producer's five chunks (rows m >= cnt zero) read MN-major, times the
    TMA box of 64 dy pixels from the segment's first pixel (zero past the
    last pixel), f32 partials summed in split order; dW rows < 16*C."""
    n, c, h, w = x.shape
    dyf = dy.reshape(-1, COUT)
    segs = segments(n, h, w, P_WG)
    splits, per = k4.wgrad_plan(n, h, w)
    xb = bits(x)
    partials = []
    for steps in wgrad_ranges(len(segs), splits, per):
        part = np.zeros((320, COUT), np.float32)
        for t in steps:
            nn, i, j0, cnt = segs[t]
            a = np.concatenate([mn_major_read(build_rows(stage_rows(xb, segs[t], g, P_WG), cnt,
                                                         P_WG)[0], P_WG) for g in range(5)])
            p0 = (nn * (h // 2) + i) * (w // 2) + j0
            box = np.zeros((P_WG, COUT), np.float32)
            box[:len(dyf[p0:p0 + P_WG])] = dyf[p0:p0 + P_WG]
            part += a @ box
        partials.append(part)
    acc = np.zeros_like(partials[0])
    for part in partials:
        acc = acc + part
    return acc[:16 * c].reshape(c, 4, 4, COUT)


@pytest.mark.parametrize("shape", [(1, 16, 24), (1, 8, 264), (1, 280, 16), (2, 6, 140)],
                         ids=["16x24", "8x264", "280x16", "n2 6x140"])
def test_split_wgrad_model_matches_pallas_and_plain(rng, shape):
    n, h, w = shape
    x, k, b, dy, w_oihw = operands(rng, n, h, w)
    got = wgrad_model(x, dy)                                  # (C, 4, 4, 64)
    _, _, gk = pallas_planar(x, k, b, dy)                     # HWIO
    ref = gk.transpose(2, 0, 1, 3)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    plain = k4.conv4x4_patch_wgrad_plain(tb(x), tb(dy)).numpy()   # OIHW
    assert np.abs(got.transpose(3, 0, 1, 2) - plain).max() <= 1e-4 * np.abs(plain).max()
