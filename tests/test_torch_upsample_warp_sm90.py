"""Kernel 6's tiled forward and dx on the CPU (csrc/upsample_warp.cu).

The CUDA kernels run only on the card (chip_smoke.py phase 8 holds them
against the plain version there). Their schedule is modelled here in numpy
with the kernel's f32 arithmetic: the tile plan
(`ops/kernels/upsample_warp.py::tile_plan`), tiles of th x tw output pixels
cut into runs of 4 pixels of one row, each tile's window of wh x ww lo-res
cells whose corner is (floor(py * s_y) - m, floor(px * s_x) - m), the split
of pixels into those whose 3x3 cells lie in the window (shared memory) and
the rest (device memory, clamped cells), dx's split of each product into
two fixed-point words or, where they would not hold it within 2^-24, an
f32 product in device memory, and dx's flush of the window's non-zero
in-image cells. The models are held against
`_sample_upsampled(..., interpret=True)` and its VJP (the Pallas kernel in
the layout of the JAX train step) and against the port's plain version, on
a smooth Warper-like flow, a flow that sends every pixel out of its
tile's window, clamped and exact-boundary positions, and the edge shape
(2, 33, 65, 19) -> 257x519. Tolerances are those of
tests/test_torch_upsample_warp.py: f32 rtol 1e-5 plus 1e-5 of the largest
magnitude; bf16 one bf16 ulp plus 2e-3 of the largest magnitude. In bf16
the Pallas reference runs in f32 on the same bf16 values: its own bf16 run
rounds the x weights to bf16 for the MXU, which the port does not do
(ROADMAP.md §3), and tests/test_torch_upsample_warp.py already holds the
plain version against that run. dx is also held cell by cell against the
exact sum of its f32 products, on cotangents whose values spread by 1e4 and
more within a tile: N(0, 1) with one outlier of 1e4 per tile, and the
cotangent of a cross-entropy loss.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.ops.pallas.upsample_warp import (
    _coords_from_flow,
    _sample_upsampled,
)
from adaptsegnet_tpu_torch.ops.kernels import upsample_warp as k6

RUN = 4  # csrc/upsample_warp.cu::kRun
F32 = np.float32


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("n,in_hw,out_hw,want", [
    # the train shape: 32 x 4 = 128 tiles of 16 x 256, window 14 x 44
    (1, (64, 128), (512, 1024), (16, 256, 4, 14, 44)),
    # the edge shape: 33 x 3 x 2 = 198 tiles of 8 x 256, the last column of
    # tiles 7 pixels wide, the last row 1 pixel high
    (2, (33, 65), (257, 519), (8, 256, 4, 13, 44)),
    # two images at the train shape: 16-row tiles, 256 of them
    (2, (64, 128), (512, 1024), (16, 256, 4, 14, 44)),
    # narrow: tw is the width rounded up to a multiple of 8; one-row tiles
    (1, (5, 6), (20, 30), (1, 32, 4, 13, 18)),
])
def test_tile_plan(n, in_hw, out_hw, want):
    plan = k6.tile_plan(n, in_hw, out_hw, 19)
    assert plan == want
    th, tw, m, wh, ww = plan
    assert tw % RUN == 0 and k6.window_bytes(wh, ww, 19) <= k6.WINDOW_BYTES
    # dx's shared memory: the window and the list of the tile's pixels
    assert k6.WINDOW_BYTES + th * tw * 4 + 16 <= 227 * 1024
    # The window holds the cells that the identity grid of every tile
    # reaches with its taps, m more on each side.
    sy, sx = k6.scales(in_hw, out_hw)
    for py in range(0, out_hw[0], th):
        rows = np.arange(py, min(py + th, out_hw[0]), dtype=F32)
        base = np.floor(rows * F32(sy)).astype(int)
        y0 = int(np.floor(F32(py) * F32(sy))) - m
        assert base.min() - y0 >= m and base.max() + 2 - y0 <= wh - 1 - m
    for px in range(0, out_hw[1], tw):
        cols = np.arange(px, min(px + tw, out_hw[1]), dtype=F32)
        base = np.floor(cols * F32(sx)).astype(int)
        x0 = int(np.floor(F32(px) * F32(sx))) - m
        assert base.min() - x0 >= m and base.max() + 2 - x0 <= ww - 1 - m


def test_tile_plan_shrinks_the_margin_then_drops_the_window():
    """Many channels: the margin shrinks until the window fits; where not
    even m = 0 fits, the window is empty (every pixel in device memory)."""
    th, tw, m, wh, ww = k6.tile_plan(1, (64, 128), (512, 1024), 64)
    assert m < k6.MARGIN and k6.window_bytes(wh, ww, 64) <= k6.WINDOW_BYTES
    assert k6.window_bytes(wh + 2, ww + 2, 64) > k6.WINDOW_BYTES
    assert k6.tile_plan(1, (64, 128), (512, 1024), 4096)[2:] == (0, 0, 0)


# ---------------------------------------------------------- the schedule


def axis_taps(i, s, n_lo):
    """csrc/upsample_warp.cu::axis_taps in f32: base cells and the three
    tap weights (..., 3); taps outside [0, n_lo) weigh 0."""
    i = np.asarray(i, F32)
    s = F32(s)
    r0 = np.floor(i)
    w1 = i - r0
    p0, p1 = r0 * s, (r0 + F32(1)) * s
    base = np.floor(p0).astype(np.int64)
    lo = base[..., None] + np.arange(3)
    lf = lo.astype(F32)
    h0 = np.maximum(F32(0), F32(1) - np.abs(p0[..., None] - lf))
    h1 = np.maximum(F32(0), F32(1) - np.abs(p1[..., None] - lf))
    w1 = w1[..., None]
    v = np.where((lo >= 0) & (lo < n_lo), h0 * (F32(1) - w1) + h1 * w1, F32(0))
    return base, v.astype(F32)


@pytest.mark.parametrize("hw,out_hw", [((64, 128), (512, 1024)), ((33, 65), (257, 519))])
def test_tap_weights_equal_the_plain_versions_bit_for_bit(rng, hw, out_hw):
    """The kernel's taps (each operation rounded on its own, in the plain
    version's order, as axis_taps here) equal the plain version's, base
    cells and weights bit for bit, on coordinates over the whole range and
    at its ends."""
    for n_lo, n_hi, s in zip(hw, out_hw, k6.scales(hw, out_hw)):
        i = np.concatenate([rng.random(4096) * (n_hi - 1), [0.0, n_hi - 1.0],
                            np.arange(n_hi, dtype=np.float64)]).astype(F32)
        base, v = axis_taps(i, s, n_lo)
        lo, pv = k6._axis_taps(torch.from_numpy(i), s, n_lo)
        np.testing.assert_array_equal(np.clip(base[:, None] + np.arange(3), 0, n_lo - 1),
                                      lo.numpy())
        np.testing.assert_array_equal(v.view(np.uint32), pv.numpy().view(np.uint32))


def runs(n, out_hw, plan):
    """The kernels' runs, in block order: (image, tile row, tile column,
    output row, first column, pixels), each of kRun pixels of one tile row
    but at the image's right edge."""
    th, tw = plan[:2]
    oh, ow = out_hw
    out = []
    for b in range(n):
        for ty in range(-(-oh // th)):
            for tx in range(-(-ow // tw)):
                for r in range(th * (tw // RUN)):
                    y = ty * th + r // (tw // RUN)
                    x = tx * tw + (r % (tw // RUN)) * RUN
                    if y < oh and x < ow:
                        out.append((b, ty, tx, y, x, min(RUN, ow - x)))
    return np.array(out, np.int64)


def schedule(iy, ix, hw, plan):
    """Every pixel of every run, in run order, with its taps and its path:
    (b, ty, tx, y, x, base_y, v_y, base_x, v_x, in_window, corner_y,
    corner_x); runs that cover a pixel twice or miss one fail here."""
    n, oh, ow = iy.shape
    th, tw, m, wh, ww = plan
    sy, sx = k6.scales(hw, (oh, ow))
    rr = runs(n, (oh, ow), plan)
    pix = np.concatenate([
        np.stack([np.full(cnt, b), np.full(cnt, ty), np.full(cnt, tx),
                  np.full(cnt, y), x + np.arange(cnt)], 1)
        for b, ty, tx, y, x, cnt in rr])
    b, ty, tx, y, x = pix.T
    seen = np.zeros((n, oh, ow), np.int64)
    np.add.at(seen, (b, y, x), 1)
    assert (seen == 1).all(), "the runs must cover each pixel exactly once"
    by, vy = axis_taps(iy[b, y, x], sy, hw[0])
    bx, vx = axis_taps(ix[b, y, x], sx, hw[1])
    y0 = np.floor((ty * th).astype(F32) * F32(sy)).astype(np.int64) - m
    x0 = np.floor((tx * tw).astype(F32) * F32(sx)).astype(np.int64) - m
    ly, lx = by - y0, bx - x0
    inw = (ly >= 0) & (ly <= wh - 3) & (lx >= 0) & (lx <= ww - 3)
    return dict(b=b, ty=ty, tx=tx, y=y, x=x, by=by, vy=vy, bx=bx, vx=vx,
                inw=inw, y0=y0, x0=x0)


def dx_model(g, iy, ix, hw, plan):
    """dx_kernel and its flush. Per tile: the largest |g| over its pixels
    and channels, rounded up to 2^e, and the busiest window cell's count of
    products n, which give fix = fix_bits(n). Each in-window product v, the
    f32 tap weight vy x vx times g, in units of 2^(e - fix), is split from
    its exact value into hi = rint(v) and lo = rint(f32(v - hi) 2^fix)
    (add_product); where |hi| >= keep_units(fix) both are summed exactly in
    the window (int32 in the kernel: the sums must stay within 2^30), else
    the f32 product goes to device memory. The window's non-zero in-image
    cells, (hi 2^fix + lo) 2^(e - 2 fix), the small products and the
    out-of-window products (f32) are summed in f64, then rounded to f32.
    Returns (dx f32, the schedule, hits, device share): hits[(pixel, tap)]
    counts the adds of that tap of that pixel over all paths; the share is
    that of the non-zero in-window products sent to device memory."""
    n, c, oh, ow = g.shape
    h, w = hw
    th, tw, m, wh, ww = plan
    s = schedule(iy, ix, hw, plan)
    b, ty, tx = s["b"], s["ty"], s["tx"]
    gv = g[b, :, s["y"], s["x"]].astype(F32)                    # (P, C)
    tiles = (n, -(-oh // th), -(-ow // tw))
    tid = np.ravel_multi_index((b, ty, tx), tiles)
    gmax = np.zeros(np.prod(tiles), F32)
    np.maximum.at(gmax, tid, np.abs(gv).max(1))
    # the busiest window cell of each tile: in-window pixels whose 3x3 holds it
    counts = np.zeros(tiles + (max(wh, 1), max(ww, 1)), np.int64)
    for a in range(3):
        for j in range(3):
            i = s["inw"]
            np.add.at(counts, (b[i], ty[i], tx[i], (s["by"] - s["y0"] + a)[i],
                               (s["bx"] - s["x0"] + j)[i]), 1)
    busiest = counts.reshape(len(gmax), -1).max(1)
    tile_e = np.maximum(np.frexp(gmax)[1], -100)
    tile_fix = np.array([k6.fix_bits(int(c)) for c in busiest])
    e, fix = tile_e[tid], tile_fix[tid]                         # per pixel
    scale = np.ldexp(F32(1), fix - e).astype(F32)
    keep = np.array([k6.keep_units(int(f)) for f in fix])
    window = (wh > 0) & np.isfinite(gmax)[tid]
    inw = s["inw"] & window
    hi_win = np.zeros(tiles + (max(wh, 1), max(ww, 1), c), np.int64)
    lo_win = np.zeros_like(hi_win)
    acc = np.zeros((n, h, w, c), np.float64)
    hits = np.zeros((len(b), 9), np.int64)
    pid = np.arange(len(b))
    ch = np.arange(c)
    small = nonzero = 0
    for a in range(3):
        for j in range(3):
            wt = (s["vy"][:, a] * s["vx"][:, j])[:, None]          # f32 weight
            v = wt * gv                                           # (P, C) f32
            cy, cx = s["by"] + a, s["bx"] + j
            i, o = inw, ~inw
            # the exact product weight x (g x scale), in f64 (48 bits)
            q = wt[i].astype(np.float64) * (gv[i] * scale[i, None]).astype(np.float64)
            hi = np.rint(q)
            lo = np.rint(np.float64((q - hi).astype(F32)) * np.ldexp(1.0, fix[i, None]))
            assert (np.abs(hi) <= 2.0 ** fix[i, None]).all()
            assert (np.abs(lo) <= 2.0 ** (fix[i, None] - 1)).all()
            kept = np.abs(hi) >= keep[i, None]
            dev = ~kept & (v[i] != 0)
            small += dev.sum()
            nonzero += (v[i] != 0).sum()
            at = (b[i, None], ty[i, None], tx[i, None], (cy - s["y0"])[i, None],
                  (cx - s["x0"])[i, None], ch)
            np.add.at(hi_win, at, np.where(kept, hi, 0).astype(np.int64))
            np.add.at(lo_win, at, np.where(kept, lo, 0).astype(np.int64))
            cyc, cxc = np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)
            np.add.at(acc, (b[i, None], cyc[i, None], cxc[i, None], ch),
                      np.where(dev, v[i], 0).astype(np.float64))
            np.add.at(acc, (b[o, None], cyc[o, None], cxc[o, None], ch),
                      v[o].astype(np.float64))
            np.add.at(hits[:, 3 * a + j], pid[i], 1)
            np.add.at(hits[:, 3 * a + j], pid[o], 1)
            # A tap outside the image weighs 0: the flush drops it.
            outside = (cy < 0) | (cy >= h) | (cx < 0) | (cx >= w)
            assert (v[outside] == 0).all()
    assert (np.abs(hi_win) <= 2 ** 30).all() and (np.abs(lo_win) <= 2 ** 30).all()
    # The flush: every non-zero window cell that lies in the image.
    sy, sx = k6.scales(hw, (oh, ow))
    tb, tyy, txx, r, qq = np.meshgrid(*(np.arange(k) for k in tiles + (wh, ww)),
                                      indexing="ij")
    cy = np.floor((tyy * th).astype(F32) * F32(sy)).astype(np.int64) - m + r
    cx = np.floor((txx * tw).astype(F32) * F32(sx)).astype(np.int64) - m + qq
    cell_e = tile_e.reshape(tiles)[tb, tyy, txx]
    cell_fix = tile_fix.reshape(tiles)[tb, tyy, txx]
    exact = (hi_win[..., :wh, :ww, :] * 2.0 ** cell_fix[..., None]
             + lo_win[..., :wh, :ww, :])
    assert (np.abs(exact) < 2.0 ** 53).all()
    vals = exact * np.ldexp(1.0, cell_e - 2 * cell_fix)[..., None]
    keep_cell = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
    np.add.at(acc, (tb[keep_cell], cy[keep_cell], cx[keep_cell]), vals[keep_cell])
    return acc.astype(F32), s, hits, small / max(nonzero, 1)


def dx_exact(g, iy, ix, hw):
    """The exact sum of each cell's f32 products (the f32 tap weights times
    g) and the sum of their magnitudes, in f64: (N, h, w, C) each."""
    n, c, oh, ow = g.shape
    h, w = hw
    sy, sx = k6.scales(hw, (oh, ow))
    by, vy = axis_taps(iy, sy, h)
    bx, vx = axis_taps(ix, sx, w)
    gv = np.moveaxis(g.astype(np.float64), 1, -1)               # (N, H, W, C)
    bb = np.arange(n)[:, None, None]
    ref, mag, cnt = (np.zeros((n, h, w, c)) for _ in range(3))
    for a in range(3):
        for j in range(3):
            wt = (vy[..., a] * vx[..., j]).astype(np.float64)[..., None]
            at = (bb, np.clip(by + a, 0, h - 1), np.clip(bx + j, 0, w - 1))
            np.add.at(ref, at, wt * gv)
            np.add.at(mag, at, np.abs(wt * gv))
            np.add.at(cnt, at, (wt * gv != 0).astype(np.float64))
    return ref, mag, cnt


def fwd_model(x, iy, ix, plan):
    """fwd_kernel: each tile's window staged from x (f32, 0 outside the
    image); a pixel in the window gathers there, any other at its clamped
    cells in x; 9 f32 products summed in tap order, rounded once."""
    n, h, w, c = x.shape
    _, oh, ow = iy.shape
    th, tw, m, wh, ww = plan
    s = schedule(iy, ix, (h, w), plan)
    xf = x.astype(F32)
    acc = np.zeros((len(s["b"]), c), F32)
    inw = s["inw"]
    for a in range(3):
        for j in range(3):
            cy, cx = s["by"] + a, s["bx"] + j
            ok = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            staged = np.where((inw & ok)[:, None],
                              xf[s["b"], np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)],
                              F32(0))
            device = xf[s["b"], np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)]
            val = np.where(inw[:, None], staged, device)
            acc += (s["vy"][:, a] * s["vx"][:, j])[:, None] * val
    out = np.zeros((n, c, oh, ow), F32)
    out[s["b"], :, s["y"], s["x"]] = acc
    return out, s


# ------------------------------------------------------------- the flows


def warper_like_flow(rng, n, out_hw):
    """A smooth field of |tanh| < ~0.1 plus per-pixel noise (the Warper's
    last layer works at full resolution), raw flow (N, 2, H, W)."""
    oh, ow = out_hw
    coarse = rng.standard_normal((n, 2, oh // 16 + 2, ow // 16 + 2)) * 0.04
    smooth = np.repeat(np.repeat(coarse, 16, 2), 16, 3)[:, :, :oh, :ow]
    return (smooth + rng.standard_normal((n, 2, oh, ow)) * 0.01).astype(F32)


def far_flow(rng, n, out_hw):
    """Every pixel clamped in y to the far edge: rows of the top half to
    row H - 1, of the bottom half to row 0, x drawn at random; at the
    shape below no tile's window reaches the far edge."""
    oh, ow = out_hw
    flow = (rng.standard_normal((n, 2, oh, ow)) * 0.5).astype(F32)
    flow[:, 1, : oh // 2] = 8.0
    flow[:, 1, oh // 2:] = -8.0
    return flow


def clamped_flow(rng, n, out_hw):
    """Random flow with clamped corners (tanh -> +-1 at both edges)."""
    flow = (rng.standard_normal((n, 2) + tuple(out_hw)) * 0.05).astype(F32)
    flow[:, :, 0, :8] = 8.0
    flow[:, :, 1, :8] = -8.0
    return flow


CASES = {  # name: (n, (h, w), (H, W), C, flow)
    "warper_like": (1, (24, 48), (192, 384), 19, warper_like_flow),
    "leaves_every_window": (1, (32, 48), (128, 192), 5, far_flow),
    "clamped_boundary": (2, (16, 24), (64, 96), 19, clamped_flow),
    "edge_shape": (2, (33, 65), (257, 519), 19, clamped_flow),
}


def positions(name, rng):
    n, hw, out_hw, c, flow_fn = CASES[name]
    flow = flow_fn(rng, n, out_hw)
    iy, ix = (np.array(a) for a in _coords_from_flow(
        jnp.asarray(flow), out_hw, planar=True))
    if name == "clamped_boundary":
        iy[:, 2, :5], ix[:, 3, :5] = out_hw[0] - 1, 0.0  # the exact boundary
    return hw, c, iy.astype(F32), ix.astype(F32)


def outlier_cotangent(rng, n, c, out_hw, plan):
    """N(0, 1), and in each tile one (pixel, channel) at +-1e4."""
    g = rng.standard_normal((n, c) + tuple(out_hw)).astype(F32)
    th, tw = plan[:2]
    for b in range(n):
        for py in range(0, out_hw[0], th):
            for px in range(0, out_hw[1], tw):
                y = rng.integers(py, min(py + th, out_hw[0]))
                x = rng.integers(px, min(px + tw, out_hw[1]))
                g[b, rng.integers(c), y, x] = 1e4 * rng.choice([-1.0, 1.0])
    return g


def ce_cotangent(rng, n, c, out_hw, plan):
    """The cotangent of a mean cross-entropy loss on logits N(0, 4^2):
    (softmax - one-hot) / valid pixels, 0 at the 10 % of pixels ignored.
    The softmax of classes far below the top spans many decades."""
    z = rng.standard_normal((n, c) + tuple(out_hw)) * 4.0
    p = np.exp(z - z.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    label = rng.integers(0, c, (n,) + tuple(out_hw))
    valid = rng.random((n,) + tuple(out_hw)) >= 0.1
    p -= np.arange(c)[None, :, None, None] == label[:, None]
    return (p * valid[:, None] / valid.sum()).astype(F32)


def pallas_vjp(x, iy, ix, g):
    """The Pallas kernel (interpret mode, f32) and its VJP at x."""
    out, vjp = jax.vjp(
        lambda xj: _sample_upsampled(xj, jnp.asarray(iy), jnp.asarray(ix),
                                     True, False, True, True),
        jnp.asarray(x, jnp.float32))
    (dx,) = vjp(jnp.asarray(g, jnp.float32))
    return np.asarray(out), np.asarray(dx)


def bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(torch.bfloat16).float().numpy()


def assert_close(got, ref, dtype, scale=None):
    scale = np.abs(ref).max() if scale is None else scale
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 2e-3 * scale), \
            np.abs(got - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_schedule_models_match_pallas_and_plain(rng, name, dtype):
    """The forward and dx models against the Pallas kernel in interpret
    mode (forward and VJP) and the plain version, with every (pixel, tap)
    added exactly once."""
    n = CASES[name][0]
    hw, c, iy, ix = positions(name, rng)
    x = rng.standard_normal((n,) + hw + (c,)).astype(F32)
    g = rng.standard_normal((n, c) + iy.shape[1:]).astype(F32)
    if dtype == "bfloat16":
        x, g = bf16_round(x), bf16_round(g)
    plan = k6.tile_plan(n, hw, iy.shape[1:], c)

    dx, sched, hits, _ = dx_model(g, iy, ix, hw, plan)
    assert (hits == 1).all()
    out, _ = fwd_model(x, iy, ix, plan)
    if dtype == "bfloat16":
        dx, out = bf16_round(dx), bf16_round(out)
    inw = sched["inw"].mean()
    if name == "leaves_every_window":
        assert inw == 0.0
    elif name == "warper_like":
        assert inw > 0.99
    ref_out, ref_dx = pallas_vjp(x, iy, ix, g)
    assert_close(out, ref_out, dtype)
    assert_close(dx, ref_dx, dtype)

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tiy, tix = torch.from_numpy(iy), torch.from_numpy(ix)
    plain_out = k6.upsample_warp_fwd_plain(torch.from_numpy(x).to(tdt), tiy, tix)
    plain_dx = k6.upsample_warp_dx_plain(torch.from_numpy(g).to(tdt), tiy, tix, hw)
    assert_close(out, plain_out.float().numpy(), dtype)
    assert_close(dx, plain_dx.float().numpy(), dtype)


def test_window_sums_equal_the_scatter(rng):
    """At the train shape's plan on a Warper-like flow (cut to 128x256 by
    scaling the lo-res grid alike): the window path and the device path
    together move every contribution once (f64 totals per channel agree),
    and the flush touches only the cells the tile's pixels reach."""
    hw, out_hw, c = (16, 32), (128, 256), 19
    flow = warper_like_flow(rng, 1, out_hw)
    iy, ix = (np.array(a, F32) for a in _coords_from_flow(
        jnp.asarray(flow), out_hw, planar=True))
    g = rng.standard_normal((1, c) + out_hw).astype(F32)
    plan = k6.tile_plan(1, hw, out_hw, c)
    dx, sched, hits, _ = dx_model(g, iy, ix, hw, plan)
    assert (hits == 1).all()
    wt = sched["vy"].sum(1) * sched["vx"].sum(1)        # each pixel's weight
    gv = g[0, :, sched["y"], sched["x"]].astype(np.float64)
    np.testing.assert_allclose(dx.astype(np.float64).sum((0, 1, 2)),
                               (wt[:, None] * gv).sum(0), rtol=1e-5, atol=1e-3)


def test_dx_wrapper_takes_the_plain_version_on_the_cpu(rng):
    """A CPU tensor runs the plain version with no launch; the result has
    g's dtype and x's layout."""
    hw, c, iy, ix = positions("clamped_boundary", rng)
    g = torch.from_numpy(rng.standard_normal((2, c) + iy.shape[1:]).astype(F32))
    before = k6.upsample_warp_dx.launches
    dx = k6.upsample_warp_dx(g.to(torch.bfloat16), torch.from_numpy(iy),
                             torch.from_numpy(ix), hw)
    assert k6.upsample_warp_dx.launches == before
    assert dx.dtype == torch.bfloat16 and dx.shape == (2,) + hw + (c,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["outlier", "cross_entropy"])
@pytest.mark.parametrize("name", ["warper_like", "clamped_boundary"])
def test_dx_per_cell_on_spread_cotangents(rng, name, kind, dtype):
    """dx cell by cell, by the cell's own magnitude, on a cotangent whose
    values spread by 1e4 and more within a tile. Against the exact sum of
    the cell's f32 products, the model is within 2^-24 of the sum of their
    magnitudes (each product enters within 2^-24 of its value, sums are
    exact or f64) plus its own rounding: 2^-24 of the value in f32, 2^-8 in
    bf16. Against the plain version, whose f32 products and sum of the
    cell's k products are within k 2^-24 of that magnitude, within the sum
    of the two bounds (its own rounding 2^-8 in bf16)."""
    n = CASES[name][0]
    hw, c, iy, ix = positions(name, rng)
    plan = k6.tile_plan(n, hw, iy.shape[1:], c)
    g = (outlier_cotangent if kind == "outlier" else ce_cotangent)(
        rng, n, c, iy.shape[1:], plan)
    if dtype == "bfloat16":
        g = bf16_round(g)
    th, tw = plan[:2]
    tile = np.abs(g[0, :, :th, :tw])
    assert tile.max() >= 1e4 * tile[tile > 0].min()      # the spread in one tile

    dx, _, hits, small = dx_model(g, iy, ix, hw, plan)
    assert (hits == 1).all()
    ref, mag, cnt = dx_exact(g, iy, ix, hw)
    rnd = 2.0 ** -24 if dtype == "float32" else 2.0 ** -8
    if dtype == "bfloat16":
        dx = bf16_round(dx)
    err = np.abs(dx - ref)
    bound = 2.0 ** -24 * mag * 1.0001 + rnd * np.abs(ref) * 1.0001
    assert (err <= bound).all(), (err / np.maximum(bound, 1e-300)).max()
    if kind == "cross_entropy":
        assert small > 0.01   # many products take the device-memory path

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    plain = k6.upsample_warp_dx_plain(
        torch.from_numpy(g).to(tdt), torch.from_numpy(iy), torch.from_numpy(ix),
        hw).float().numpy().astype(np.float64)
    plain_bound = (cnt * 2.0 ** -24 * mag + rnd * np.abs(ref)) * 1.0001
    assert (np.abs(dx - plain) <= bound + plain_bound + rnd * np.abs(plain)).all()
