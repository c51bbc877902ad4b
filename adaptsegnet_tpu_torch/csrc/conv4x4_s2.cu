// torch Conv2d(k=4, s=2, p=1) on NHWC bf16 with f32 accumulation: the
// discriminator's conv2..conv4 (64->128, 128->256, 256->512) and the
// Warper encoder's down1..out (64->128 at 256x512 in ... 512->512 at 4x8
// in), forward, dgrad and wgrad.
//
// Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/conv4x4_s2.py
// (`conv4x4_s2_mxu`: `_fwd_kernel`, `_wgrad_kernel`, `_dgrad_kernel`), which
// builds the space-to-depth blocks in VMEM so that each direction is a few
// MXU matmuls. On the card no space-to-depth is needed:
//   fwd:   implicit GEMM on the Hopper core (csrc/igemm_sm90.cuh), M =
//          N*Ho*Wo, K = 16*Cin, N = Cout; input pixel (2i + ky - 1,
//          2j + kx - 1), zero padding on load; the f32 bias is added before
//          the one rounding to bf16. Where the 128 x 128 tiles cannot fill
//          the card (the encoder's down3..out, D conv4) the wrapper's plan
//          cuts K into `splits` ranges and csrc/splitk.cuh sums the f32
//          partials in split order, adds the bias and rounds once.
//   dgrad: gather form on the same core. dx pixel (2p + py, 2q + px) takes
//          the taps ky = 1 - py + 2a, kx = 1 - px + 2b (a, b in {0, 1}) from
//          dy pixel (p + py - a, q + px - b): for each of the four parity
//          classes (blockIdx.z) an implicit GEMM with K = 4*Cout against
//          that class's K-major (Cin, 4*Cout) weight matrix (built by the
//          wrapper). Every dx element is written once: no atomics.
//   wgrad: dW[(ky, kx, ci), co] = sum over pixels of x(src) * dy, a GEMM of
//          (16*Cin, Cout) reduced over M = N*Ho*Wo on wmma fragments
//          (csrc/igemm_bf16.cuh's cp.async helpers). The pixels are split
//          into `splits` ranges, one f32 partial each (split-K), and a
//          second pass sums the partials in split order: deterministic, f32
//          out.
//
// Bound on the H100: at D conv2..4 and the encoder's down1..3 each
// direction is 8.59 GFLOP against a few MB of traffic, i.e. tensor-core
// bound (989 TFLOP/s bf16 dense); at down4..out (output 16x32 .. 2x4,
// K = 8,192) the 8.4 MB weight read bounds the call (2.5-4.3 us), which
// is why the forward splits K there: 4-16 output tiles become >= 132
// blocks that each read a slice of the weights once.

#include "igemm_bf16.cuh"
#include "igemm_sm90.cuh"
#include "splitk.cuh"

namespace {

using namespace nvcuda;
using igemm::cp_async16;
using igemm::cp_async_commit;
using igemm::cp_async_wait;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kLd = 128 + 8;  // bf16 per smem row: 128 rows-or-cols + pad
constexpr size_t kWgradSmem =
    2 * kStages * kBK * kLd * sizeof(__nv_bfloat16);

// ws[split][r][co] = sum over this split's pixels m of
//   x[n, 2i + ky - 1, 2j + kx - 1, ci] * dy[m, co], r = (ky*4 + kx)*cin + ci.
// A^T tile in smem as [pixel][r] (wmma matrix_a col_major), dy as
// [pixel][co] (matrix_b row_major).
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ dy, float* __restrict__ ws,
             int n, int h, int w, int cin, int cout, int pix_per_split) {
  extern __shared__ __align__(16) unsigned char wgrad_smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(wgrad_smem);
  __nv_bfloat16* sB = sA + kStages * kBK * kLd;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int r0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN, s = blockIdx.z;
  const int ho = h / 2, wo = w / 2;
  const int M = n * ho * wo;
  const int p0 = s * pix_per_split;
  const int p1 = min(p0 + pix_per_split, M);
  const int KT = (p1 - p0 + kBK - 1) / kBK;

  const int vec = tid & 15, kk0 = tid >> 4;  // pixels kk0, kk0 + 16
  const int r = r0 + vec * 8;
  const int tap = r / cin, ci = r - tap * cin;
  const int ky = tap >> 2, kx = tap & 3;

  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* dA = sA + stage * kBK * kLd;
    __nv_bfloat16* dB = sB + stage * kBK * kLd;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int kk = kk0 + q * 16;
      const int m = p0 + kt * kBK + kk;
      const bool in = m < p1;
      const int mm = in ? m : 0;
      const int j = mm % wo, t = mm / wo;
      const int i = t % ho, nn = t / ho;
      const int y = 2 * i + ky - 1, xx = 2 * j + kx - 1;
      const bool ok = in && y >= 0 && y < h && xx >= 0 && xx < w;
      const __nv_bfloat16* pa =
          ok ? x + ((static_cast<size_t>(nn) * h + y) * w + xx) * cin + ci : x;
      cp_async16(dA + kk * kLd + vec * 8, pa, ok);
      const __nv_bfloat16* pb =
          in ? dy + static_cast<size_t>(mm) * cout + c0 + vec * 8 : dy;
      cp_async16(dB + kk * kLd + vec * 8, pb, in);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = kt + kStages - 1;
    if (pre < KT) load_stage(pre % kStages, pre);
    cp_async_commit();
    const __nv_bfloat16* tA = sA + (kt % kStages) * kBK * kLd;
    const __nv_bfloat16* tB = sB + (kt % kStages) * kBK * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], tA + kk * kLd + wm * 32 + i * 16, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], tB + kk * kLd + wn * 64 + j * 16, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const size_t rows = static_cast<size_t>(16) * cin;
  float* dst = ws + static_cast<size_t>(s) * rows * cout;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          dst + static_cast<size_t>(r0 + wm * 32 + i * 16) * cout + c0 +
              wn * 64 + j * 16,
          acc[i][j], cout, wmma::mem_row_major);
}

}  // namespace

// x: (n, h, w, cin) bf16; wt: (cout, 16 * cin) bf16, K-major, column
// (ky*4 + kx)*cin + ci; bias: (cout,) f32 or null; out: (n, h/2, w/2, cout)
// bf16; bm (128, or 64 for tiny M), splits and per (K steps of 64 per
// split) from the wrapper's plan; ws: (splits, n*h/2*w/2, cout) f32 when
// splits > 1, else null. cin % 64 == 0, cout % 8 == 0.
extern "C" int asn_conv4x4_s2_fwd(const void* x, const void* wt,
                                  const void* bias, void* out, void* ws,
                                  int n, int h, int w, int cin, int cout,
                                  int bm, int splits, int per, void* stream) {
  sm90::Geo g;
  g.n = n;
  g.oh = h / 2;
  g.ow = w / 2;
  g.sh = h;
  g.sw = w;
  g.cs = cin;
  g.kw = 4;
  g.taps = 16;
  g.rs = 2;
  g.ry = -1;
  g.rx = -1;
  g.tmul = 1;
  g.tadd = 0;
  g.os = 1;
  g.oh_out = h / 2;
  g.ow_out = w / 2;
  g.ncols = cout;
  g.zpar = 0;
  g.splits = splits;
  g.per = per;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = sm90::launch(x, wt, bias, out, ws, g, bm, 128, s);
  if (err || splits == 1) return err;
  return splitk::sum_splits_bf16(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), splits,
      static_cast<long long>(n) * (h / 2) * (w / 2) * cout, cout, s);
}

// dy: (n, h/2, w/2, cout) bf16; wt: (4, cin, 4 * cout) bf16, class
// z = 2*py + px, K-major row ci, column (2a + b)*cout + co holding
// W[co, ci, 1-py+2a, 1-px+2b]; dx: (n, h, w, cin) bf16.
extern "C" int asn_conv4x4_s2_dgrad(const void* dy, const void* wt, void* dx,
                                    int n, int h, int w, int cin, int cout,
                                    void* stream) {
  sm90::Geo g;
  g.n = n;
  g.oh = h / 2;
  g.ow = w / 2;
  g.sh = h / 2;
  g.sw = w / 2;
  g.cs = cout;
  g.kw = 2;
  g.taps = 4;
  g.rs = 1;
  g.ry = 0;
  g.rx = 0;
  g.tmul = -1;
  g.tadd = 0;
  g.os = 2;
  g.oh_out = h;
  g.ow_out = w;
  g.ncols = cin;
  g.zpar = 1;
  g.splits = 1;
  g.per = 4 * cout / sm90::kBK;
  return sm90::launch(dy, wt, nullptr, dx, nullptr, g, 128, 128,
                      static_cast<cudaStream_t>(stream));
}

// x: (n, h, w, cin) bf16; dy: (n, h/2, w/2, cout) bf16; ws: (splits, 16*cin,
// cout) f32 scratch; dk: (16*cin, cout) f32, row (ky*4 + kx)*cin + ci.
// 16*cin % 128 == 0, cout % 128 == 0.
extern "C" int asn_conv4x4_s2_wgrad(const void* x, const void* dy, void* ws,
                                    void* dk, int n, int h, int w, int cin,
                                    int cout, int splits, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kWgradSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n * (h / 2) * (w / 2);
  int per = (m + splits - 1) / splits;
  per = (per + kBK - 1) / kBK * kBK;
  const dim3 grid(16 * cin / kBM, cout / kBN, splits);
  wgrad_kernel<<<grid, kThreads, kWgradSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(ws), n, h, w,
      cin, cout, per);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return splitk::sum_splits(static_cast<const float*>(ws),
                            static_cast<float*>(dk), splits,
                            static_cast<long long>(16) * cin * cout, s);
}
