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
// (20 MB bf16). x (0.3 MB) and the dx accumulator (0.6 MB) stay in L2.
//   * forward: one thread per output pixel; 9 tap weights in f32; per
//     channel 9 fmas from x (L1/L2 hits: ~64 neighbouring pixels share a
//     cell at an 8x upsample) and one planar store, coalesced across the
//     warp, rounded once to x's dtype.
//   * d-flow: one thread per pixel, no atomics: t_ab = sum_c g[c] x[ab, c]
//     over the 9 cells, then the two weighted sums. f32 out.
//   * dx: the sampling is data-dependent, so there is no fixed transpose.
//     Each thread takes a run of kRun consecutive pixels of one row and,
//     per channel, sums the run's weighted cotangents in 9 registers while
//     its pixels share one 3x3 cell window, then adds each non-zero sum to
//     an (N, C, h, w) f32 buffer with atomicAdd (L2-resident, 0.6 MB). A
//     second kernel converts the buffer to (N, h, w, C) in x's dtype. The
//     sum order of the atomics varies from run to run. The Warper's flow is
//     smooth, so most runs keep one window; the device-memory atomics set
//     the time. (A per-block shared-memory copy of the cells around each
//     tile, with device-memory atomics only for cells outside it, measured
//     slower on the H100 and was dropped; PERF.md has the numbers.)
// Nothing carries between blocks (the TPU dx accumulates over a sequential
// grid axis; that does not translate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDxThreads = 128;
constexpr int kRun = 8;  // dx: consecutive output pixels per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.f, 1.f - fabsf(d));
}

// The three lo-res taps of one axis: base index, weights v and d(v)/d(i).
// Out-of-range taps get weight 0 and are read at a clamped index.
struct Taps {
  int base;
  float v[3];
  float dv[3];
};

__device__ __forceinline__ Taps axis_taps(float i, float s, int n_lo) {
  Taps t;
  const float r0 = floorf(i);
  const float w1 = i - r0;
  const float p0 = r0 * s;
  const float p1 = (r0 + 1.f) * s;
  t.base = static_cast<int>(floorf(p0));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int l = t.base + k;
    const float lf = static_cast<float>(l);
    const float h0 = hat(p0 - lf);
    const float h1 = hat(p1 - lf);
    const bool ok = l >= 0 && l < n_lo;
    t.v[k] = ok ? h0 * (1.f - w1) + h1 * w1 : 0.f;
    t.dv[k] = ok ? h1 - h0 : 0.f;
  }
  return t;
}

__device__ __forceinline__ int clampi(int v, int n) {
  return min(max(v, 0), n - 1);
}

struct Geo {
  int n, h, w, c, p;  // x (n, h, w, c); p = H * W output pixels per image
  float sy, sx;
};

// Offsets (in elements of x, within one image) of the 3x3 cells.
__device__ __forceinline__ void cell_offsets(const Taps& ty, const Taps& tx,
                                             const Geo& g, int off[9]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      off[3 * a + b] =
          (clampi(ty.base + a, g.h) * g.w + clampi(tx.base + b, g.w)) * g.c;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const float* __restrict__ iy,
           const float* __restrict__ ix, T* __restrict__ out, Geo g) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= static_cast<int64_t>(g.n) * g.p) return;
  const int b = static_cast<int>(q / g.p);
  const int p = static_cast<int>(q - static_cast<int64_t>(b) * g.p);
  const Taps ty = axis_taps(iy[q], g.sy, g.h);
  const Taps tx = axis_taps(ix[q], g.sx, g.w);
  int off[9];
  float wt[9];
  cell_offsets(ty, tx, g, off);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) wt[3 * a + k] = ty.v[a] * tx.v[k];
  }
  const T* xb = x + static_cast<size_t>(b) * g.h * g.w * g.c;
  T* ob = out + static_cast<size_t>(b) * g.c * g.p + p;
  for (int ch = 0; ch < g.c; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc = fmaf(wt[t], to_f32(xb[off[t] + ch]), acc);
    ob[static_cast<size_t>(ch) * g.p] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dflow_kernel(const T* __restrict__ x, const T* __restrict__ gr,
             const float* __restrict__ iy, const float* __restrict__ ix,
             float* __restrict__ diy, float* __restrict__ dix, Geo g) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= static_cast<int64_t>(g.n) * g.p) return;
  const int b = static_cast<int>(q / g.p);
  const int p = static_cast<int>(q - static_cast<int64_t>(b) * g.p);
  const Taps ty = axis_taps(iy[q], g.sy, g.h);
  const Taps tx = axis_taps(ix[q], g.sx, g.w);
  int off[9];
  cell_offsets(ty, tx, g, off);
  const T* xb = x + static_cast<size_t>(b) * g.h * g.w * g.c;
  const T* gb = gr + static_cast<size_t>(b) * g.c * g.p + p;
  float t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = 0.f;
  for (int ch = 0; ch < g.c; ++ch) {
    const float gc = to_f32(gb[static_cast<size_t>(ch) * g.p]);
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

// Add the sums s (cells (cy + a, cx + j), t = 3a + j) to one channel's
// plane of the f32 buffer, and zero them.
__device__ __forceinline__ void add_cells(float (&s)[9], int cy, int cx,
                                          const Geo& g, float* plane) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (s[t] != 0.f) {
      atomicAdd(plane + clampi(cy + t / 3, g.h) * g.w + clampi(cx + t % 3, g.w),
                s[t]);
    }
    s[t] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDxThreads)
dx_kernel(const T* __restrict__ gr, const float* __restrict__ iy,
          const float* __restrict__ ix, float* __restrict__ acc, Geo g) {
  const int runs = (g.p + kRun - 1) / kRun;  // runs per image
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kDxThreads + threadIdx.x;
  if (r >= static_cast<int64_t>(g.n) * runs) return;
  const int b = static_cast<int>(r / runs);
  const int p0 = static_cast<int>(r - static_cast<int64_t>(b) * runs) * kRun;
  const int cnt = min(kRun, g.p - p0);
  const int64_t q0 = static_cast<int64_t>(b) * g.p + p0;

  int by[kRun], bx[kRun];
  float vy[kRun][3], vx[kRun][3];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int kk = min(k, cnt - 1);  // a short tail repeats its last pixel
    const Taps ty = axis_taps(iy[q0 + kk], g.sy, g.h);
    const Taps tx = axis_taps(ix[q0 + kk], g.sx, g.w);
    by[k] = ty.base;
    bx[k] = tx.base;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      vy[k][a] = ty.v[a];
      vx[k][a] = tx.v[a];
    }
  }
  const T* gb = gr + static_cast<size_t>(b) * g.c * g.p + p0;
  float* ab = acc + static_cast<size_t>(b) * g.c * g.h * g.w;
  for (int ch = 0; ch < g.c; ++ch) {
    const T* gc = gb + static_cast<size_t>(ch) * g.p;
    float* plane = ab + static_cast<size_t>(ch) * g.h * g.w;
    float s[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) s[t] = 0.f;
    int cy = by[0], cx = bx[0];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < cnt) {
        if (by[k] != cy || bx[k] != cx) {  // the cell window moved
          add_cells(s, cy, cx, g, plane);
          cy = by[k];
          cx = bx[k];
        }
        const float gv = to_f32(gc[k]);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            s[3 * a + j] = fmaf(vy[k][a] * vx[k][j], gv, s[3 * a + j]);
          }
        }
      }
    }
    add_cells(s, cy, cx, g, plane);
  }
}

// (N, C, h, w) f32 sums -> (N, h, w, C) in x's dtype, rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_finish_kernel(const float* __restrict__ acc, T* __restrict__ dx, Geo g) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t hw = static_cast<int64_t>(g.h) * g.w;
  if (e >= g.n * hw * g.c) return;
  const int ch = static_cast<int>(e % g.c);
  const int64_t pix = e / g.c;  // b * h * w + y * w + x
  const int64_t b = pix / hw;
  dx[e] = from_f32<T>(acc[(b * g.c + ch) * hw + (pix - b * hw)]);
}

unsigned blocks(int64_t work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

template <typename T>
int launch_fwd(const void* x, const void* iy, const void* ix, void* out,
               Geo g, cudaStream_t s) {
  fwd_kernel<T><<<blocks(static_cast<int64_t>(g.n) * g.p, kThreads), kThreads,
                  0, s>>>(static_cast<const T*>(x),
                          static_cast<const float*>(iy),
                          static_cast<const float*>(ix), static_cast<T*>(out),
                          g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx(const void* gr, const void* iy, const void* ix, void* acc,
              void* dx, Geo g, cudaStream_t s) {
  const int64_t runs = static_cast<int64_t>(g.n) * ((g.p + kRun - 1) / kRun);
  dx_kernel<T><<<blocks(runs, kDxThreads), kDxThreads, 0, s>>>(
      static_cast<const T*>(gr), static_cast<const float*>(iy),
      static_cast<const float*>(ix), static_cast<float*>(acc), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_el = static_cast<int64_t>(g.n) * g.h * g.w * g.c;
  dx_finish_kernel<T><<<blocks(n_el, kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(acc), static_cast<T*>(dx), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dflow(const void* x, const void* gr, const void* iy, const void* ix,
                 void* diy, void* dix, Geo g, cudaStream_t s) {
  dflow_kernel<T><<<blocks(static_cast<int64_t>(g.n) * g.p, kThreads),
                    kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<const float*>(iy), static_cast<const float*>(ix),
      static_cast<float*>(diy), static_cast<float*>(dix), g);
  return static_cast<int>(cudaGetLastError());
}

Geo make_geo(int n, int h, int w, int c, int oh, int ow, float sy, float sx) {
  return Geo{n, h, w, c, oh * ow, sy, sx};
}

}  // namespace

// Shapes: x (n, h, w, c) and g, out (n, c, oh, ow) in x's dtype (f32 when
// is_bf16 = 0, bf16 when 1); iy, ix, diy, dix (n, oh, ow) f32; acc (n, c, h,
// w) f32, zero on entry; dx (n, h, w, c) in x's dtype. All contiguous.
// sy = (h-1)/(oh-1), sx = (w-1)/(ow-1), both <= 1. Each returns the
// cudaError_t of its launches (0 = success).
extern "C" int asn_upsample_warp_fwd(const void* x, const void* iy,
                                     const void* ix, void* out, int is_bf16,
                                     int n, int h, int w, int c, int oh,
                                     int ow, float sy, float sx,
                                     void* stream) {
  const Geo g = make_geo(n, h, w, c, oh, ow, sy, sx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, iy, ix, out, g, s)
                 : launch_fwd<float>(x, iy, ix, out, g, s);
}

extern "C" int asn_upsample_warp_dx(const void* gr, const void* iy,
                                    const void* ix, void* acc, void* dx,
                                    int is_bf16, int n, int h, int w, int c,
                                    int oh, int ow, float sy, float sx,
                                    void* stream) {
  const Geo g = make_geo(n, h, w, c, oh, ow, sy, sx);
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
  const Geo g = make_geo(n, h, w, c, oh, ow, sy, sx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dflow<__nv_bfloat16>(x, gr, iy, ix, diy, dix, g, s)
                 : launch_dflow<float>(x, gr, iy, ix, diy, dix, g, s);
}
