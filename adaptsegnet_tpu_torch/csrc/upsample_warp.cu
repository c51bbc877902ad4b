// Fused align-corners bilinear upsample + flow warp (kernel 6): forward, dx
// and d-flow, one entry point each.
//
// Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/upsample_warp.py
// (`upsample_warp` -> `_sample_upsampled`), all six of its pallas_calls: the
// pixel-lane family (fwd `_fwd_kernel_px`, dx `_bwd_x_kernel_px`, d-flow
// `_bwd_flow_kernel_px`) and the lane-over-channel family (`_fwd_kernel`,
// `_bwd_x_kernel`, `_bwd_flow_kernel`) compute the same three functions,
// which are the three entry points below.
//
// The function. x is (N, h, w, C) low-res logits; (iy, ix) (N, H, W) f32 are
// hi-res sample positions. With s_y = (h-1)/(H-1), the hi-res row r has the
// lo-res weight hat(r*s_y - l) = max(0, 1 - |r*s_y - l|) on lo row l, and the
// sample at iy lerps hi rows r0 = floor(iy) and r0+1 with weights 1-wy, wy:
//   VY[p, l] = (1-wy) hat(r0*s_y - l) + wy hat((r0+1)*s_y - l),  l in [0, h)
//   out[c, p] = sum_{ly, lx} VY[p, ly] VX[p, lx] x[ly, lx, c]
//   dx[ly, lx, c] = sum_p VY[p, ly] VX[p, lx] g[c, p]
//   diy[p] = sum_c g[c, p] sum_{ly, lx} dVY[p, ly] VX[p, lx] x[ly, lx, c]
// with dVY = hat((r0+1)*s - l) - hat(r0*s - l), and dix the same with the
// axes swapped. For s <= 1 (an upsample) VY has its non-zeros on the three
// lo rows floor(r0*s) .. floor(r0*s)+2, and taps outside [0, h) are dropped,
// exactly as the dense TPU form drops them (so iy = H-1, whose second tap is
// the virtual row H with weight 0, reads nothing out of bounds).
//
// Bound on the H100: memory. The TPU kernel's dense "hat" contractions
// (~2000x the needed operations) exist only because the TPU has no fast
// gather; here each output pixel gathers its 3x3 lo-res cells directly, so
// the work is ~20 f32 fmas per pixel and channel and the floor is the bytes:
// the coordinates (4 MB at 512x1024) and the planar output or cotangent
// (20 MB bf16).
//
// Tiles and windows (forward and dx). A block of 1024 threads owns a tile of
// th x tw output pixels (16 x 256 at 512x1024: 128 tiles, about one per SM;
// ops/kernels/upsample_warp.py::tile_plan) and keeps, in shared memory, a
// window of the lo-res cells that the tile's identity grid reaches (its 3x3
// taps included) plus a margin of m = 4 cells on each side: wh x ww cells of
// all C channels, channel-minor, each cell padded to an even channel count
// so that a channel pair is one shared load (14 x 44 cells at the train
// shape).
//   * A pixel whose 3x3 cells lie in the window uses shared memory. Any other
//     pixel (a flow that moves it more than m cells off the identity grid, a
//     sample clamped at the image edge) is listed in shared memory as the
//     in-window pass meets it and done after that pass by the whole block,
//     one (pixel, channel) per thread, in device memory at the same clamped
//     cells as the plain version. Both give the same function for any flow;
//     only the speed depends on the flow.
//   * forward: the window is staged from x once per block in x's dtype
//     (coalesced, eight loads in flight per thread; cells outside the image
//     read as 0 and weigh 0). One thread per output pixel (a warp: 32
//     consecutive pixels of a row, whose shared loads broadcast): its 9 tap
//     weights vy[a] * vx[j] once, then per channel pair 9 shared loads and
//     18 fmas in tap order, each output rounded once to x's dtype and stored
//     to its plane (a warp's stores are contiguous).
//   * dx: the card has no shared-memory f32 add (atomicAdd on a shared float
//     compiles to a compare-and-swap loop, ATOMS.CAST.SPIN, and so does a
//     64-bit integer add), so the window sums in fixed point with the native
//     int32 shared-memory add, two words per cell and channel. A first pass
//     over the tile finds its largest |g|, rounded up to a power of two 2^e,
//     and counts for each window cell the in-window pixels whose 3x3 holds
//     it; with n the largest count, fix = min(22, 30 - ceil(log2 n)) bits
//     keep every int32 sum within 2^30 (fix = 21 at the train shape, where
//     the busiest window cell takes ~400 products). Each product v = w g
//     (w the f32 tap weight) is split from its exact value into hi, v
//     rounded to units of 2^(e - fix) (one fma with 1.5 * 2^23), and lo, the
//     rest rounded to units of 2^(e - 2 fix) (two fmas): together within
//     2^-26 + 2^-(fix + 1) units of v. Where |hi| >= 2^(24 - fix) that is
//     less than 2^-24 of v, and hi and lo go to the window's two sums; a
//     smaller non-zero product goes to device memory as the f32 product w g.
//     So every product enters dx within 2^-24 of its value, as an f32
//     product would, however the values of g in a tile spread; only the
//     speed depends on the spread. A thread takes runs of kRun = 4 pixels of
//     a row (lanes 4 pixels apart, so few share a cell), one pixel at a
//     time, all channels, a pair at a time, the next pair's cotangent
//     loading meanwhile. The block adds its non-zero in-image cells, exactly
//     converted (hi 2^fix + lo < 2^53), to an (N, h, w, C) f64 buffer in
//     device memory (native f64 atomics), where the out-of-window and the
//     small products go too (exactly widened from f32); a block whose
//     largest |g| is not finite sends every product there. A second kernel
//     rounds the buffer once, through f32, to dx's dtype. So a cell of dx
//     differs from the exact sum of its f32 products by at most 2^-24 of
//     the sum of their magnitudes (plus 2^-53 of it from the f64 adds) and
//     its own rounding. The f64 adds come in no fixed order, so dx is not
//     bit-reproducible in general.
//   * d-flow (no main path runs it): one thread per pixel, no atomics:
//     t_ab = sum_c g[c] x[ab, c] over the 9 cells, then the two weighted
//     sums. f32 out.
// Nothing carries between blocks (the TPU dx accumulates over a sequential
// grid axis; that does not translate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 1024;  // tiled kernels: 32 warps, one block per SM
constexpr int kFlatThreads = 256;  // one thread per element
constexpr int kRun = 4;  // dx: consecutive output pixels of one row per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(d)));
}

// The three lo-res taps of one axis: base index, weights v and d(v)/d(i).
// Out-of-range taps get weight 0 and are read at a clamped index. Each
// operation rounds on its own (no fma contraction: 1 - |r s - l| cancels,
// so a fused r s - l would move a small weight by up to ~3e-4 of itself),
// in the plain version's order, so the weights equal its weights bit for
// bit.
struct Taps {
  int base;
  float v[3];
  float dv[3];
};

__device__ __forceinline__ Taps axis_taps(float i, float s, int n_lo) {
  Taps t;
  const float r0 = floorf(i);
  const float w1 = __fsub_rn(i, r0);
  const float p0 = __fmul_rn(r0, s);
  const float p1 = __fmul_rn(__fadd_rn(r0, 1.f), s);
  t.base = static_cast<int>(floorf(p0));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int l = t.base + k;
    const float lf = static_cast<float>(l);
    const float h0 = hat(__fsub_rn(p0, lf));
    const float h1 = hat(__fsub_rn(p1, lf));
    const bool ok = l >= 0 && l < n_lo;
    t.v[k] = ok ? __fadd_rn(__fmul_rn(h0, __fsub_rn(1.f, w1)), __fmul_rn(h1, w1)) : 0.f;
    t.dv[k] = ok ? __fsub_rn(h1, h0) : 0.f;
  }
  return t;
}

__device__ __forceinline__ int clampi(int v, int n) {
  return min(max(v, 0), n - 1);
}

struct Geo {
  int n, h, w, c, oh, ow;  // x (n, h, w, c); output (n, c, oh, ow)
  float sy, sx;
  int th, tw, m, wh, ww;   // tile and window (tile_plan)
  bool vec;                // dx's runs as vectors: W % 4 == 0, 16-byte aligned
  __host__ __device__ int64_t p() const { return static_cast<int64_t>(oh) * ow; }
};

// Offset (in elements of x, within one image) of lo-res cell (y, x), clamped.
__device__ __forceinline__ int cell_at(const Geo& g, int y, int x) {
  return (clampi(y, g.h) * g.w + clampi(x, g.w)) * g.c;
}

// One tile of th x tw output pixels of image b, and its window of wh x ww
// lo-res cells whose corner is lo-res cell (y0, x0).
struct Tile {
  int b, py, px;  // image, first output row and column
  int y0, x0;     // window corner (may lie outside the image)
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int block) {
  const int tiles_x = (g.ow + g.tw - 1) / g.tw;
  const int tiles_y = (g.oh + g.th - 1) / g.th;
  Tile t;
  t.b = block / (tiles_x * tiles_y);
  const int r = block - t.b * tiles_x * tiles_y;
  t.py = (r / tiles_x) * g.th;
  t.px = (r % tiles_x) * g.tw;
  t.y0 = static_cast<int>(floorf(static_cast<float>(t.py) * g.sy)) - g.m;
  t.x0 = static_cast<int>(floorf(static_cast<float>(t.px) * g.sx)) - g.m;
  return t;
}

// Window channel stride: C rounded up to even, so that a channel pair is one
// shared load (4 bytes of bf16, 8 of f32).
__host__ __device__ __forceinline__ int pair_stride(int c) { return (c + 1) & ~1; }

// The window's layout: channel ch of cell (r, q) at (r * ww + q) * cp + ch,
// with cp = pair_stride(c).
struct Layout {
  int cp, rc;
  __device__ explicit Layout(const Geo& g) : cp(pair_stride(g.c)), rc(g.ww) {}
  __device__ int at(int r, int q) const { return (r * rc + q) * cp; }
  __device__ int tap(int t) const { return ((t / 3) * rc + t % 3) * cp; }
};

__device__ __forceinline__ void load_run(const float* src, bool vec, int cnt,
                                         float (&v)[kRun]) {
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = src[min(k, cnt - 1)];
  }
}
__device__ __forceinline__ void load_run(const __nv_bfloat16* src, bool vec,
                                         int cnt, float (&v)[kRun]) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = to_f32(src[min(k, cnt - 1)]);
  }
}

// The elements (window row r, column q, channel ch) of a window, in NHWC
// order, kThreads apart, stepped without a division.
struct Walk {
  int r, q, ch, dq, dch;
  __device__ Walk(const Geo& g, int e) {
    const int cell = e / g.c;
    ch = e - cell * g.c;
    r = cell / g.ww;
    q = cell - r * g.ww;
    dq = kThreads / g.c;
    dch = kThreads - dq * g.c;
  }
  __device__ void step(const Geo& g) {
    ch += dch;
    q += dq;
    if (ch >= g.c) {
      ch -= g.c;
      ++q;
    }
    while (q >= g.ww) {
      q -= g.ww;
      ++r;
    }
  }
};

// The block's window of x in x's dtype (L's layout): cell (r, q) is lo-res
// cell (y0 + r, x0 + q), 0 outside the image and in the pad channels.
// Coalesced NHWC reads, eight in flight per thread.
template <typename T>
__device__ __forceinline__ void stage_window(const Geo& g, const Tile& t,
                                             const Layout& L,
                                             const T* __restrict__ xb, T* win) {
  if (L.cp != g.c) {
    for (int i = threadIdx.x; i < g.wh * L.rc; i += kThreads) {
      for (int ch = g.c; ch < L.cp; ++ch) win[i * L.cp + ch] = T(0.f);
    }
  }
  const int total = g.wh * g.ww * g.c;
  Walk w(g, threadIdx.x);
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * kThreads) {
    T v[8];
    int dst[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int y = t.y0 + w.r, xx = t.x0 + w.q;
      const bool ok = e0 + u * kThreads < total && y >= 0 && y < g.h && xx >= 0 &&
                      xx < g.w;
      v[u] = ok ? xb[(static_cast<size_t>(y) * g.w + xx) * g.c + w.ch] : T(0.f);
      dst[u] = L.at(w.r, w.q) + w.ch;
      w.step(g);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (e0 + u * kThreads < total) win[dst[u]] = v[u];
    }
  }
}

// A channel pair of the window: two f32, or two bf16 widened exactly.
__device__ __forceinline__ float2 pair_at(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// A pixel's 9 tap weights vy[a] * vx[j] (t = 3a + j) and whether its 3x3
// cells lie in the window, then (ly, lx) = its corner cell in the window.
struct PixelTaps {
  float wt[9];
  bool in;
  int ly, lx;
};

__device__ __forceinline__ PixelTaps pixel_taps(const Geo& g, const Tile& t,
                                                bool window, float fy,
                                                float fx) {
  const Taps ty = axis_taps(fy, g.sy, g.h), tx = axis_taps(fx, g.sx, g.w);
  PixelTaps p;
#pragma unroll
  for (int k = 0; k < 9; ++k) p.wt[k] = __fmul_rn(ty.v[k / 3], tx.v[k % 3]);
  p.ly = ty.base - t.y0;
  p.lx = tx.base - t.x0;
  p.in = window && p.ly >= 0 && p.ly <= g.wh - 3 && p.lx >= 0 && p.lx <= g.ww - 3;
  return p;
}

// The device-memory paths of a pixel whose cells leave the window: its taps
// again from its coordinates, then channel ch gathered from x or its
// products added to acc, in the window paths' order.
template <typename T>
__device__ __forceinline__ float gather_device(const T* __restrict__ xb, float fy,
                                               float fx, int ch, const Geo& g) {
  const Taps ty = axis_taps(fy, g.sy, g.h), tx = axis_taps(fx, g.sx, g.w);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    s = fmaf(__fmul_rn(ty.v[k / 3], tx.v[k % 3]),
             to_f32(xb[cell_at(g, ty.base + k / 3, tx.base + k % 3) + ch]), s);
  }
  return s;
}

__device__ __forceinline__ void scatter_device(double* __restrict__ ab, float fy,
                                               float fx, float gv, int ch,
                                               const Geo& g) {
  const Taps ty = axis_taps(fy, g.sy, g.h), tx = axis_taps(fx, g.sx, g.w);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float v = __fmul_rn(__fmul_rn(ty.v[k / 3], tx.v[k % 3]), gv);
    if (v != 0.f) {
      atomicAdd(ab + cell_at(g, ty.base + k / 3, tx.base + k % 3) + ch,
                static_cast<double>(v));
    }
  }
}

// The pixels of a tile whose cells leave its window are listed in shared
// memory (their index in the tile) as the in-window pass meets them, and
// done after it by the whole block, one (pixel, channel) per thread, so that
// their device-memory loads and atomics overlap instead of holding up the
// warps that met them.
struct OutList {
  int* pix;
  int* count;
  __device__ void add(int i) const { pix[atomicAdd(count, 1)] = i; }
};

// One thread per output pixel of the tile (a warp: 32 consecutive pixels of
// a row, which share few cells, so shared loads broadcast).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const T* __restrict__ x, const float* __restrict__ iy,
           const float* __restrict__ ix, T* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);  // (wh, rc, cp) in x's dtype, then the list
  __shared__ int n_out;
  const Tile t = tile_of(g, blockIdx.x);
  const Layout L(g);
  const OutList list{
      reinterpret_cast<int*>(smem + (g.wh * L.rc * L.cp * sizeof(T) + 15) / 16 * 16),
      &n_out};
  const T* xb = x + static_cast<size_t>(t.b) * g.h * g.w * g.c;
  if (threadIdx.x == 0) n_out = 0;
  stage_window(g, t, L, xb, win);
  __syncthreads();

  const bool window = g.wh > 0;
  T* ob = out + static_cast<size_t>(t.b) * g.c * g.p();
  for (int i = threadIdx.x; i < g.th * g.tw; i += kThreads) {
    const int y = t.py + i / g.tw, x0 = t.px + i % g.tw;
    if (y >= g.oh || x0 >= g.ow) continue;
    const int64_t p = static_cast<int64_t>(y) * g.ow + x0;
    const PixelTaps pt = pixel_taps(g, t, window, iy[t.b * g.p() + p], ix[t.b * g.p() + p]);
    if (!pt.in) {
      list.add(i);
      continue;
    }
    const T* w0 = win + L.at(pt.ly, pt.lx);
    T* op = ob + p;
    for (int ch = 0; ch < g.c; ch += 2) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float2 v = pair_at(w0 + L.tap(k) + ch);
        s0 = fmaf(pt.wt[k], v.x, s0);
        s1 = fmaf(pt.wt[k], v.y, s1);
      }
      op[static_cast<size_t>(ch) * g.p()] = from_f32<T>(s0);
      if (ch + 1 < g.c) op[static_cast<size_t>(ch + 1) * g.p()] = from_f32<T>(s1);
    }
  }
  __syncthreads();

  for (int it = threadIdx.x; it < n_out * g.c; it += kThreads) {  // device memory
    const int j = it / g.c, ch = it - j * g.c, i = list.pix[j];
    const int64_t p = static_cast<int64_t>(t.py + i / g.tw) * g.ow + t.px + i % g.tw;
    ob[static_cast<size_t>(ch) * g.p() + p] = from_f32<T>(
        gather_device(xb, iy[t.b * g.p() + p], ix[t.b * g.p() + p], ch, g));
  }
}

// Fixed-point bits of dx's window sums: each product is at most 2^fix units
// and the busiest window cell takes n products (one per in-window pixel
// whose 3x3 holds it), so with fix = 30 - ceil(log2(n)) no int32 sum leaves
// [-2^30, 2^30] (and fix <= 22 keeps to_fixed exact).
__device__ __forceinline__ int fix_bits(int n) {
  return min(22, 30 - (32 - __clz(max(n, 1) - 1)));
}

constexpr float kMagic = 12582912.f;  // 1.5 * 2^23

// Round the exact product a * b (|a * b| <= 2^22) to the nearest integer:
// the fma with 1.5 * 2^23 leaves it in the low mantissa bits.
__device__ __forceinline__ int to_fixed(float a, float b) {
  return __float_as_int(fmaf(a, b, kMagic)) - 0x4B400000;
}

// The product w * g to one window cell: gs = g 2^(fix - e), so w * gs is
// the product in units and |w * gs| <= 2^fix. Its integer part hi and the
// rest lo in units of 2^-fix (lscale = 2^fix), both rounded from the exact
// values, go to the cell's two sums where |hi| >= keep = 2^(24 - fix);
// then hi + lo 2^-fix is within 2^-24 of the product. A smaller non-zero
// product goes to `dev`, the cell in device memory, as the f32 product.
__device__ __forceinline__ void add_product(int* hi_sum, int* lo_sum,
                                            double* dev, float w, float g,
                                            float gs, float lscale, int keep) {
  const float t = fmaf(w, gs, kMagic);
  const int hi = __float_as_int(t) - 0x4B400000;
  if (abs(hi) >= keep) {
    atomicAdd(hi_sum, hi);
    const int lo = to_fixed(fmaf(w, gs, kMagic - t), lscale);  // kMagic - t = -hi
    if (lo != 0) atomicAdd(lo_sum, lo);
  } else {
    const float v = w * g;
    if (v != 0.f) atomicAdd(dev, static_cast<double>(v));
  }
}

// acc: (n, h, w, c) f64, zero on entry; gets dx.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dx_kernel(const T* __restrict__ gr, const float* __restrict__ iy,
          const float* __restrict__ ix, double* __restrict__ acc, Geo g) {
  // (wh, ww, cp) sums of hi, the same of lo, (wh, ww) counts, the list
  extern __shared__ int sums[];
  __shared__ unsigned block_max;
  __shared__ int max_count, n_out;
  const Tile t = tile_of(g, blockIdx.x);
  const Layout L(g);
  const int size = g.wh * L.rc * L.cp, cells = g.wh * L.rc;
  int* lows = sums + size;
  int* counts = lows + size;
  const OutList list{counts + cells, &n_out};
  for (int e = threadIdx.x; e < 2 * size + cells; e += kThreads) sums[e] = 0;
  if (threadIdx.x == 0) {
    block_max = 0;
    max_count = 0;
    n_out = 0;
  }
  __syncthreads();

  // Pass 1: the tile's largest |g| (as bits: NaN and inf order above every
  // finite value), a run of kRun pixels per thread and load, and how many
  // in-window pixels reach each window cell.
  const int runs = g.th * (g.tw / kRun);
  const int per_row = g.tw / kRun;
  const T* gbase = gr + static_cast<size_t>(t.b) * g.c * g.p();
  unsigned m = 0;
  for (int r = threadIdx.x; r < runs; r += kThreads) {
    const int y = t.py + r / per_row, x = t.px + (r % per_row) * kRun;
    if (y >= g.oh || x >= g.ow) continue;
    const int cnt = min(kRun, g.ow - x);
    const bool vec = cnt == kRun && g.vec;
    const T* gp = gbase + static_cast<size_t>(y) * g.ow + x;
#pragma unroll 4
    for (int ch = 0; ch < g.c; ++ch) {
      float gv[kRun];
      load_run(gp + static_cast<size_t>(ch) * g.p(), vec, cnt, gv);
#pragma unroll
      for (int k = 0; k < kRun; ++k) m = max(m, __float_as_uint(gv[k]) & 0x7fffffffu);
    }
#pragma unroll 1
    for (int k = 0; k < cnt; ++k) {
      const int64_t q = t.b * g.p() + static_cast<int64_t>(y) * g.ow + x + k;
      const PixelTaps pt = pixel_taps(g, t, g.wh > 0, iy[q], ix[q]);
      if (pt.in) {
#pragma unroll
        for (int j = 0; j < 9; ++j) atomicAdd(counts + (pt.ly + j / 3) * L.rc + pt.lx + j % 3, 1);
      }
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) atomicMax(&block_max, m);
  __syncthreads();
  int n = 0;
  for (int i = threadIdx.x; i < cells; i += kThreads) n = max(n, counts[i]);
  n = __reduce_max_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0) atomicMax(&max_count, n);
  __syncthreads();
  const float gmax = __uint_as_float(block_max);
  const bool window = g.wh > 0 && gmax <= 3.402823466e38f;  // finite
  int e = 0;
  frexpf(gmax, &e);  // gmax <= 2^e
  e = max(e, -100);
  const int fix = fix_bits(max_count);
  const float scale = ldexpf(1.f, fix - e), lscale = ldexpf(1.f, fix);
  const int keep = 1 << (24 - fix);

  // Pass 2: every in-window product to its window cell (add_product). A
  // thread takes the pixels of its run one at a time (lanes kRun pixels
  // apart, so few share a cell), all channels of a pixel, a pair at a time,
  // the next pair's cotangent loading meanwhile.
  double* ab = acc + static_cast<size_t>(t.b) * g.h * g.w * g.c;
  for (int r = threadIdx.x; r < runs; r += kThreads) {
    const int y = t.py + r / per_row, x0 = t.px + (r % per_row) * kRun;
    if (y >= g.oh || x0 >= g.ow) continue;
    const int cnt = min(kRun, g.ow - x0);
#pragma unroll 1
    for (int k = 0; k < cnt; ++k) {
      const int64_t p = static_cast<int64_t>(y) * g.ow + x0 + k;
      const PixelTaps pt = pixel_taps(g, t, window, iy[t.b * g.p() + p],
                                      ix[t.b * g.p() + p]);
      if (!pt.in) {
        list.add((y - t.py) * g.tw + x0 + k - t.px);
        continue;
      }
      const T* gp = gbase + p;
      const int s0 = L.at(pt.ly, pt.lx);
      // the window corner's cell in device memory (outside the image where
      // the window is; only the taps of non-zero products are written)
      double* d0 = ab + (static_cast<int64_t>(t.y0 + pt.ly) * g.w + t.x0 + pt.lx) * g.c;
      float n0 = to_f32(gp[0]);
      float n1 = g.c > 1 ? to_f32(gp[g.p()]) : 0.f;
      for (int ch = 0; ch < g.c; ch += 2) {
        const float g0 = n0, g1 = n1, gs0 = n0 * scale, gs1 = n1 * scale;
        if (ch + 2 < g.c) {
          n0 = to_f32(gp[static_cast<size_t>(ch + 2) * g.p()]);
          n1 = ch + 3 < g.c ? to_f32(gp[static_cast<size_t>(ch + 3) * g.p()]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const int cell = s0 + L.tap(j) + ch;
          double* dev = d0 + ((j / 3) * g.w + j % 3) * g.c + ch;
          add_product(sums + cell, lows + cell, dev, pt.wt[j], g0, gs0, lscale, keep);
          add_product(sums + cell + 1, lows + cell + 1, dev + 1, pt.wt[j], g1, gs1,
                      lscale, keep);  // g1 = 0 past the last channel
        }
      }
    }
  }
  __syncthreads();

  for (int it = threadIdx.x; it < n_out * g.c; it += kThreads) {  // device memory
    const int j = it / g.c, ch = it - j * g.c, i = list.pix[j];
    const int64_t p = static_cast<int64_t>(t.py + i / g.tw) * g.ow + t.px + i % g.tw;
    scatter_device(ab, iy[t.b * g.p() + p], ix[t.b * g.p() + p],
                   to_f32(gbase[static_cast<size_t>(ch) * g.p() + p]), ch, g);
  }

  // Flush the non-zero cells that lie in the image, NHWC order (coalesced):
  // hi 2^fix + lo, exact in f64, in units of 2^(e - 2 fix).
  if (!window) return;
  const double unit = ldexp(1.0, e - 2 * fix), hi_unit = ldexp(1.0, fix);
  Walk w(g, threadIdx.x);
  for (int i = threadIdx.x; i < g.wh * g.ww * g.c; i += kThreads, w.step(g)) {
    const int at = L.at(w.r, w.q) + w.ch;
    const int hi = sums[at], lo = lows[at];
    const int y = t.y0 + w.r, xx = t.x0 + w.q;
    if ((hi != 0 || lo != 0) && y >= 0 && y < g.h && xx >= 0 && xx < g.w) {
      atomicAdd(ab + (static_cast<size_t>(y) * g.w + xx) * g.c + w.ch,
                fma(static_cast<double>(hi), hi_unit, static_cast<double>(lo)) * unit);
    }
  }
}

// f64 sums -> dx's dtype, rounded once through f32 (as the plain version's
// f32 gradient is).
template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
round_kernel(const double* __restrict__ acc, T* __restrict__ dx, int64_t n_el) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kFlatThreads + threadIdx.x;
  if (e < n_el) {
    const float v = __double2float_rn(acc[e]);
    if constexpr (sizeof(T) == sizeof(float)) {
      dx[e] = v;
    } else {
      dx[e] = __float2bfloat16_rn(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
dflow_kernel(const T* __restrict__ x, const T* __restrict__ gr,
             const float* __restrict__ iy, const float* __restrict__ ix,
             float* __restrict__ diy, float* __restrict__ dix, Geo g) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kFlatThreads + threadIdx.x;
  if (q >= static_cast<int64_t>(g.n) * g.p()) return;
  const int b = static_cast<int>(q / g.p());
  const int64_t p = q - static_cast<int64_t>(b) * g.p();
  const Taps ty = axis_taps(iy[q], g.sy, g.h);
  const Taps tx = axis_taps(ix[q], g.sx, g.w);
  const T* xb = x + static_cast<size_t>(b) * g.h * g.w * g.c;
  const T* gb = gr + static_cast<size_t>(b) * g.c * g.p() + p;
  int off[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) off[k] = cell_at(g, ty.base + k / 3, tx.base + k % 3);
  float t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = 0.f;
  for (int ch = 0; ch < g.c; ++ch) {
    const float gc = to_f32(gb[static_cast<size_t>(ch) * g.p()]);
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = fmaf(gc, to_f32(xb[off[k] + ch]), t[k]);
  }
  float sy = 0.f, sx = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sy = fmaf(ty.dv[a] * tx.v[k], t[3 * a + k], sy);
      sx = fmaf(ty.v[a] * tx.dv[k], t[3 * a + k], sx);
    }
  }
  diy[q] = sy;
  dix[q] = sx;
}

unsigned blocks(int64_t work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

unsigned tiles(const Geo& g) {
  return static_cast<unsigned>(g.n) * ((g.oh + g.th - 1) / g.th) *
         ((g.ow + g.tw - 1) / g.tw);
}

// Shared memory of a block: the window (the forward's in x's dtype, or dx's
// two int32 sums and its per-cell counts), then the list of the tile's
// pixels whose cells leave it.
size_t window_bytes(const Geo& g, size_t elem, bool dx) {
  const size_t cells = static_cast<size_t>(g.wh) * g.ww;
  const size_t win = dx ? cells * (2 * pair_stride(g.c) + 1) * 4
                        : cells * pair_stride(g.c) * elem;
  return (win + 15) / 16 * 16 + static_cast<size_t>(g.th) * g.tw * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_fwd(const void* x, const void* iy, const void* ix, void* out,
               Geo g, cudaStream_t s) {
  const auto kernel = fwd_kernel<T>;
  const size_t smem = window_bytes(g, sizeof(T), false);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles(g), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(iy),
      static_cast<const float*>(ix), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx(const void* gr, const void* iy, const void* ix, void* acc,
              void* dx, Geo g, cudaStream_t s) {
  const auto kernel = dx_kernel<T>;
  const size_t smem = window_bytes(g, sizeof(int), true);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles(g), kThreads, smem, s>>>(
      static_cast<const T*>(gr), static_cast<const float*>(iy),
      static_cast<const float*>(ix), static_cast<double*>(acc), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_el = static_cast<int64_t>(g.n) * g.h * g.w * g.c;
  round_kernel<T><<<blocks(n_el, kFlatThreads), kFlatThreads, 0, s>>>(
      static_cast<const double*>(acc), static_cast<T*>(dx), n_el);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dflow(const void* x, const void* gr, const void* iy, const void* ix,
                 void* diy, void* dix, Geo g, cudaStream_t s) {
  dflow_kernel<T><<<blocks(static_cast<int64_t>(g.n) * g.p(), kFlatThreads),
                    kFlatThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<const float*>(iy), static_cast<const float*>(ix),
      static_cast<float*>(diy), static_cast<float*>(dix), g);
  return static_cast<int>(cudaGetLastError());
}

Geo make_geo(int n, int h, int w, int c, int oh, int ow, float sy, float sx,
             int th, int tw, int m, int wh, int ww,
             std::initializer_list<const void*> ptrs) {
  bool vec = ow % kRun == 0;  // runs start kRun-aligned
  for (const void* p : ptrs) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return Geo{n, h, w, c, oh, ow, sy, sx, th, tw, m, wh, ww, vec};
}

}  // namespace

// Shapes: x (n, h, w, c) and g, out (n, c, oh, ow) in x's dtype (f32 when
// is_bf16 = 0, bf16 when 1); iy, ix, diy, dix (n, oh, ow) f32; acc (n, h, w,
// c) f64, zero on entry; dx (n, h, w, c) in g's dtype. All contiguous. sy = (h-1)/(oh-1), sx = (w-1)/(ow-1), both <= 1.
// (th, tw, m, wh, ww) come from tile_plan (tw a multiple of 8). Each returns
// the cudaError_t of its launches (0 = success).
extern "C" int asn_upsample_warp_fwd(const void* x, const void* iy,
                                     const void* ix, void* out, int is_bf16,
                                     int n, int h, int w, int c, int oh,
                                     int ow, float sy, float sx, int th,
                                     int tw, int m, int wh, int ww,
                                     void* stream) {
  const Geo g = make_geo(n, h, w, c, oh, ow, sy, sx, th, tw, m, wh, ww,
                         {x, iy, ix, out});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, iy, ix, out, g, s)
                 : launch_fwd<float>(x, iy, ix, out, g, s);
}

extern "C" int asn_upsample_warp_dx(const void* gr, const void* iy,
                                    const void* ix, void* acc, void* dx,
                                    int is_bf16, int n, int h, int w, int c,
                                    int oh, int ow, float sy, float sx, int th,
                                    int tw, int m, int wh, int ww,
                                    void* stream) {
  const Geo g = make_geo(n, h, w, c, oh, ow, sy, sx, th, tw, m, wh, ww,
                         {gr, iy, ix});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dx<__nv_bfloat16>(gr, iy, ix, acc, dx, g, s)
                 : launch_dx<float>(gr, iy, ix, acc, dx, g, s);
}

extern "C" int asn_upsample_warp_dflow(const void* x, const void* gr,
                                       const void* iy, const void* ix,
                                       void* diy, void* dix, int is_bf16,
                                       int n, int h, int w, int c, int oh,
                                       int ow, float sy, float sx,
                                       void* stream) {
  const Geo g = make_geo(n, h, w, c, oh, ow, sy, sx, 0, 0, 0, 0, 0, {});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dflow<__nv_bfloat16>(x, gr, iy, ix, diy, dix, g, s)
                 : launch_dflow<float>(x, gr, iy, ix, diy, dix, g, s);
}
