// The discriminator's conv1: torch Conv2d(C, 64, k=4, s=2, p=1) over the
// planar (N, C, H, W) softmax map (C = 19), bf16 in, f32 accumulation;
// forward (NHWC bf16 out + f32 bias), wgrad (f32) and dgrad (planar bf16).
//
// Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/conv4x4_patch.py
// (`conv4x4_s2_phases_planar`: `_fwd_kernel`, `_wgrad_kernel`,
// `_dgrad_kernel`). The TPU version consumes four stride-2 parity phases of
// the padded map, a layout chosen for the TPU's 128-lane tiles. Here the
// kernels read the dense planar map directly, zero padding applied on load,
// and build the (pixels x 16*C) patch matrix in shared memory:
//   fwd:   one block per 128 output pixels of one output row; the patch
//          matrix is built 64 columns at a time (K = 16*C padded to 320,
//          column k = c*16 + ky*4 + kx) and multiplied by the packed
//          (320, 64) weights held in shared memory.
//   wgrad: the same patch chunks, contracted over pixels: each block owns one
//          64-row chunk of the (320, 64) result and a range of 128-pixel
//          segments (split-K); a second pass sums the partials in order.
//   dgrad: one block per 128 pixels of one row of the map: K = 2 row taps x
//          4 column taps x 64 channels, the dy pixel of each tap gathered
//          (zero where the tap's parity does not match the pixel's), times
//          the row parity's (512, 32) weight matrix; written back planar.
//
// Bound on the H100: forward 5.10 GFLOP against ~36.7 MB (19.9 MB of bf16
// map in, 16.8 MB out): bound by bytes (~11 us at 3.35 TB/s). The design
// reads the map once per output row pair with no phase or padded copy in
// device memory; the products run on wmma bf16 fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "splitk.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kSeg = 128;   // pixels per block row segment
constexpr int kCout = 64;
constexpr int kKP = 320;    // 16*C padded (C <= 20)
constexpr int kChunk = 64;  // patch columns per chunk
constexpr int kLd = 72;     // bf16 per smem row (64 + pad)
constexpr int kLdB = 40;    // bf16 per dgrad weight row (32 + pad)
constexpr int kDgK = 512;   // dgrad K: 2 row taps x 4 col taps x 64
constexpr size_t kChunkBytes = kSeg * kLd * sizeof(__nv_bfloat16);
constexpr size_t kFwdSmem = kKP * kLd * sizeof(__nv_bfloat16) + kChunkBytes;
constexpr size_t kWgradSmem = 2 * kChunkBytes;
constexpr size_t kDgradSmem =
    kDgK * kLdB * sizeof(__nv_bfloat16) + kChunkBytes;

// Patch chunk kc of output row i, columns j0..j0+127 of image nn:
// sA[m][kk] = x[nn, c, 2i + ky - 1, 2(j0 + m) + kx - 1], k = kc*64 + kk =
// c*16 + ky*4 + kx; zero outside the map, for k >= 16*C and past Wo.
__device__ __forceinline__ void build_patch(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* sA, int nn, int i,
    int j0, int kc, int c, int h, int w, int wo) {
  const int m = threadIdx.x & (kSeg - 1);
  const int half = threadIdx.x >> 7;
  const int xm = 2 * (j0 + m) - 1;
  const bool col_ok = j0 + m < wo;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int q = 0; q < kChunk / 2; ++q) {
    const int kk = half * (kChunk / 2) + q;
    const int k = kc * kChunk + kk;
    const int ch = k >> 4, ky = (k >> 2) & 3, kx = k & 3;
    const int y = 2 * i + ky - 1, xx = xm + kx;
    const bool ok = col_ok && ch < c && y >= 0 && y < h && xx >= 0 && xx < w;
    sA[m * kLd + kk] =
        ok ? x[((static_cast<size_t>(nn) * c + ch) * h + y) * w + xx] : zero;
  }
}

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ wpk,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
           int c, int h, int w) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(fwd_smem);
  __nv_bfloat16* sA = sW + kKP * kLd;
  const int ho = h / 2, wo = w / 2;
  const int j0 = blockIdx.x * kSeg, i = blockIdx.y, nn = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 32 x 32 per warp

  for (int v = tid; v < kKP * 8; v += kThreads) {
    const int row = v >> 3, col = (v & 7) * 8;
    *reinterpret_cast<uint4*>(sW + row * kLd + col) =
        *reinterpret_cast<const uint4*>(wpk + row * kCout + col);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.0f);

  for (int kc = 0; kc < kKP / kChunk; ++kc) {
    build_patch(x, sA, nn, i, j0, kc, c, h, w, wo);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], sA + (wm * 32 + a * 16) * kLd + kk, kLd);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(
            fb[b], sW + (kc * kChunk + kk) * kLd + wn * 32 + b * 16, kLd);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* scratch = reinterpret_cast<float*>(sA) + warp * 256;
  const int lr = lane >> 1, lc = (lane & 1) * 8;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wmma::store_matrix_sync(scratch, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = wm * 32 + a * 16 + lr;
      const int col = wn * 32 + b * 16 + lc;
      if (j0 + m < wo) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16_rn(scratch[lr * 16 + lc + e] + bias[col + e]);
        const size_t pix = (static_cast<size_t>(nn) * ho + i) * wo + j0 + m;
        *reinterpret_cast<uint4*>(out + pix * kCout + col) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// ws[s][k][co] over segments [s*segs, (s+1)*segs) of 128 output pixels, for
// the 64 patch columns of chunk blockIdx.y.
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ dy, float* __restrict__ ws,
             int n, int c, int h, int w, int segs) {
  extern __shared__ __align__(16) unsigned char wgrad_smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(wgrad_smem);
  __nv_bfloat16* sD = sA + kSeg * kLd;
  const int ho = h / 2, wo = w / 2;
  const int tiles = (wo + kSeg - 1) / kSeg;
  const int total = n * ho * tiles;
  const int s = blockIdx.x, kc = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rf = warp >> 1, cf0 = (warp & 1) * 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  const int g1 = min((s + 1) * segs, total);
  for (int g = s * segs; g < g1; ++g) {
    const int jt = g % tiles, t = g / tiles;
    const int i = t % ho, nn = t / ho, j0 = jt * kSeg;
    build_patch(x, sA, nn, i, j0, kc, c, h, w, wo);
    for (int v = tid; v < kSeg * 8; v += kThreads) {
      const int m = v >> 3, col = (v & 7) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (j0 + m < wo)
        val = *reinterpret_cast<const uint4*>(
            dy + ((static_cast<size_t>(nn) * ho + i) * wo + j0 + m) * kCout +
            col);
      *reinterpret_cast<uint4*>(sD + m * kLd + col) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSeg; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa;
      wmma::load_matrix_sync(fa, sA + kk * kLd + rf * 16, kLd);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sD + kk * kLd + (cf0 + b) * 16, kLd);
        wmma::mma_sync(acc[b], fa, fb, acc[b]);
      }
    }
    __syncthreads();
  }
  float* dst = ws + (static_cast<size_t>(s) * kKP + kc * kChunk + rf * 16) *
                        kCout;
#pragma unroll
  for (int b = 0; b < 2; ++b)
    wmma::store_matrix_sync(dst + (cf0 + b) * 16, acc[b], kCout,
                            wmma::mem_row_major);
}

// dx[nn, :, y, x0..x0+127] from dy (n, h/2, w/2, 64) and the row parity's
// weight matrix wpy[y & 1] (512, 32): row (a*4 + kx)*64 + co holds
// W[co, ch, 1 - py + 2a, kx] (columns ch >= C zero).
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const __nv_bfloat16* __restrict__ dy,
             const __nv_bfloat16* __restrict__ wpy,
             __nv_bfloat16* __restrict__ dx, int c, int h, int w) {
  extern __shared__ __align__(16) unsigned char dgrad_smem[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(dgrad_smem);
  __nv_bfloat16* sA = sB + kDgK * kLdB;
  const int ho = h / 2, wo = w / 2;
  const int x0 = blockIdx.x * kSeg, y = blockIdx.y, nn = blockIdx.z;
  const int py = y & 1;
  const int tid = threadIdx.x, warp = tid >> 5;

  const __nv_bfloat16* wsrc = wpy + static_cast<size_t>(py) * kDgK * 32;
  for (int v = tid; v < kDgK * 4; v += kThreads) {
    const int row = v >> 2, col = (v & 3) * 8;
    *reinterpret_cast<uint4*>(sB + row * kLdB + col) =
        *reinterpret_cast<const uint4*>(wsrc + row * 32 + col);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int t = 0; t < 8; ++t) {
    const int a = t >> 2, kx = t & 3;
    const int ky = 1 - py + 2 * a;
    const int iy = (y + 1 - ky) >> 1;  // y + 1 - ky is even by construction
    const bool row_ok = iy >= 0 && iy < ho;
    for (int v = tid; v < kSeg * 8; v += kThreads) {
      const int m = v >> 3, col = (v & 7) * 8;
      const int d = x0 + m + 1 - kx;
      const int jx = d >> 1;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row_ok && x0 + m < w && d >= 0 && (d & 1) == 0 && jx < wo)
        val = *reinterpret_cast<const uint4*>(
            dy + ((static_cast<size_t>(nn) * ho + iy) * wo + jx) * kCout + col);
      *reinterpret_cast<uint4*>(sA + m * kLd + col) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kCout; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + warp * 16 * kLd + kk, kLd);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + (t * kCout + kk) * kLdB + b * 16,
                               kLdB);
        wmma::mma_sync(acc[b], fa, fb, acc[b]);
      }
    }
    __syncthreads();
  }

  float* sC = reinterpret_cast<float*>(sA);  // [128][36] f32
#pragma unroll
  for (int b = 0; b < 2; ++b)
    wmma::store_matrix_sync(sC + warp * 16 * 36 + b * 16, acc[b], 36,
                            wmma::mem_row_major);
  __syncthreads();
  const int m = tid & (kSeg - 1);
  if (x0 + m < w) {
    for (int ch = tid >> 7; ch < c; ch += 2)
      dx[((static_cast<size_t>(nn) * c + ch) * h + y) * w + x0 + m] =
          __float2bfloat16_rn(sC[m * 36 + ch]);
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool g_configured = false;

int configure() {
  if (g_configured) return 0;
  int err = set_smem(reinterpret_cast<const void*>(fwd_kernel), kFwdSmem);
  if (!err) err = set_smem(reinterpret_cast<const void*>(dgrad_kernel),
                           kDgradSmem);
  if (!err) err = set_smem(reinterpret_cast<const void*>(wgrad_kernel),
                           kWgradSmem);
  g_configured = err == 0;
  return err;
}

}  // namespace

// x: (n, c, h, w) bf16 planar, c <= 20, h and w even; wpk: (320, 64) bf16,
// row c*16 + ky*4 + kx (rows >= 16c zero); bias: (64,) f32;
// out: (n, h/2, w/2, 64) bf16.
extern "C" int asn_conv4x4_patch_fwd(const void* x, const void* wpk,
                                     const void* bias, void* out, int n,
                                     int c, int h, int w, void* stream) {
  int err = configure();
  if (err) return err;
  const dim3 grid((w / 2 + kSeg - 1) / kSeg, h / 2, n);
  fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wpk), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), c, h, w);
  return static_cast<int>(cudaGetLastError());
}

// dy: (n, h/2, w/2, 64) bf16; ws: (splits, 320, 64) f32 scratch;
// dk: (320, 64) f32, row c*16 + ky*4 + kx.
extern "C" int asn_conv4x4_patch_wgrad(const void* x, const void* dy,
                                       void* ws, void* dk, int n, int c,
                                       int h, int w, int splits,
                                       void* stream) {
  int err = configure();
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = n * (h / 2) * ((w / 2 + kSeg - 1) / kSeg);
  const int segs = (total + splits - 1) / splits;
  const dim3 grid(splits, kKP / kChunk);
  wgrad_kernel<<<grid, kThreads, kWgradSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(ws), n, c, h,
      w, segs);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return splitk::sum_splits(static_cast<const float*>(ws),
                            static_cast<float*>(dk), splits,
                            static_cast<long long>(kKP) * kCout, s);
}

// dy: (n, h/2, w/2, 64) bf16; wpy: (2, 512, 32) bf16; dx: (n, c, h, w) bf16.
extern "C" int asn_conv4x4_patch_dgrad(const void* dy, const void* wpy,
                                       void* dx, int n, int c, int h, int w,
                                       void* stream) {
  int err = configure();
  if (err) return err;
  const dim3 grid((w + kSeg - 1) / kSeg, h, n);
  dgrad_kernel<<<grid, kThreads, kDgradSmem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(wpy), static_cast<__nv_bfloat16*>(dx),
      c, h, w);
  return static_cast<int>(cudaGetLastError());
}
