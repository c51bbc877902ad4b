// Implicit-GEMM convolution core on bf16 tensor cores (nvcuda::wmma 16x16x16,
// f32 accumulators): kernel 2's forward and dgrad (csrc/conv3x3_dil.cu).
// Kernels 3 and 5 run on the Hopper core, csrc/igemm_sm90.cuh; kernel 5's
// wgrad uses this file's cp.async helpers.
//
// Output rows are pixels, columns output channels: out[M, Ncols] =
// A[M, K] @ B[K, Ncols], where B is the weight matrix (K = taps * Cs rows,
// row (tap, c)) and A is never materialised: row m of A is the Cs channels of
// one source pixel per tap, read straight from the NHWC source with zero
// padding applied on load (cp.async with a zero source size). The geometry
// (`Geo`) maps an output-grid pixel (n, i, j) and a tap (ty, tx) to its source
// pixel and to the pixel it is written to.
//
// Block tile 128 x 128, K step 32, three cp.async stages; 8 warps, each a
// 32 x 64 tile (2 x 4 fragments). The epilogue converts each fragment through
// a per-warp 16x16 f32 scratch and writes 16-byte bf16 vectors.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

// Internal linkage throughout: each .cu builds its own shared library, and
// an inline function's static (or the function itself) would otherwise be a
// unique symbol that the dynamic loader binds across the loaded libraries.
namespace igemm {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;   // bf16 elements per smem A row (80 bytes)
constexpr int kLdB = kBN + 8;   // bf16 elements per smem B row (272 bytes)
constexpr int kSmemA = kStages * kBM * kLdA;  // elements
constexpr int kSmemB = kStages * kBK * kLdB;
constexpr size_t kSmemBytes = (kSmemA + kSmemB) * sizeof(__nv_bfloat16);

// out-grid pixel (n, i, j) and tap t = ty * kw + tx:
//   source (n, i*rs + ry + ty*tmul + tadd, j*rs + rx + tx*tmul + tadd) of an
//   (N, sh, sw, cs) NHWC tensor (zero outside);
//   written to (n, i*os + oy, j*os + ox) of an (N, oh_out, ow_out, ncols)
//   NHWC tensor.
struct Geo {
  int n, oh, ow;          // output grid (rows of A = n * oh * ow)
  int sh, sw, cs;         // source tensor
  int kw, taps;           // taps per kernel row, taps in all
  int rs, ry, rx;         // source base = (i * rs + ry, j * rs + rx)
  int tmul, tadd;         // tap offset = t{y,x} * tmul + tadd
  int os, oh_out, ow_out; // destination pixel = (i * os + oy, j * os + ox)
  int ncols;              // output channels (columns of B)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int size = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(size));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
conv_igemm_kernel(const __nv_bfloat16* __restrict__ src,
                  const __nv_bfloat16* __restrict__ wmat,
                  __nv_bfloat16* __restrict__ out, Geo g) {
  using namespace nvcuda;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + kSmemA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int M = g.n * g.oh * g.ow;
  const int K = g.taps * g.cs;
  const int KT = K / kBK;

  const __nv_bfloat16* B = wmat;

  // This thread's two A rows (fixed over the K loop) and vector slot.
  const int a_vec = tid & 3;  // 8 channels each
  int a_n[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + (tid >> 2) + r * 64;
    a_ok[r] = m < M;
    const int mm = a_ok[r] ? m : 0;
    const int j = mm % g.ow;
    const int t = mm / g.ow;
    a_n[r] = t / g.oh;
    a_y[r] = (t % g.oh) * g.rs + g.ry;
    a_x[r] = j * g.rs + g.rx;
  }
  const int b_row = tid >> 4, b_vec = tid & 15;  // rows b_row, b_row + 16

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int tap = k0 / g.cs;
    const int c0 = k0 - tap * g.cs + a_vec * 8;
    const int offy = (tap / g.kw) * g.tmul + g.tadd;
    const int offx = (tap % g.kw) * g.tmul + g.tadd;
    __nv_bfloat16* dA = sA + stage * kBM * kLdA;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = a_y[r] + offy, x = a_x[r] + offx;
      const bool ok = a_ok[r] && y >= 0 && y < g.sh && x >= 0 && x < g.sw;
      const __nv_bfloat16* p =
          ok ? src + ((static_cast<size_t>(a_n[r]) * g.sh + y) * g.sw + x) *
                         g.cs + c0
             : src;
      cp_async16(dA + ((tid >> 2) + r * 64) * kLdA + a_vec * 8, p, ok);
    }
    __nv_bfloat16* dB = sB + stage * kBK * kLdB;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = b_row + r * 16;
      const int col = n0 + b_vec * 8;
      const bool ok = col < g.ncols;
      const __nv_bfloat16* p =
          ok ? B + static_cast<size_t>(k0 + row) * g.ncols + col : B;
      cp_async16(dB + row * kLdB + b_vec * 8, p, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = kt + kStages - 1;
    if (pre < KT) load_stage(pre % kStages, pre);
    cp_async_commit();

    const __nv_bfloat16* tA = sA + (kt % kStages) * kBM * kLdA;
    const __nv_bfloat16* tB = sB + (kt % kStages) * kBK * kLdB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], tB + kk * kLdB + wn * 64 + j * 16,
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: fragment -> per-warp f32 scratch -> (+ bias) -> bf16 x 8.
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int lr = lane >> 1, lc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + lr;
      const int col = n0 + wn * 64 + j * 16 + lc;
      if (m < M && col < g.ncols) {
        const int jj = m % g.ow;
        const int t = m / g.ow;
        const int nn = t / g.oh, ii = t % g.oh;
        const size_t pix =
            (static_cast<size_t>(nn) * g.oh_out + ii * g.os) * g.ow_out +
            jj * g.os;
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16_rn(scratch[lr * 16 + lc + e]);
        *reinterpret_cast<uint4*>(out + pix * g.ncols + col) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// Launch on `stream`. Returns the launch's cudaError_t (0 = success).
inline int launch(const void* src, const void* wmat, void* out, const Geo& g,
                  cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_igemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int M = g.n * g.oh * g.ow;
  const dim3 grid((M + kBM - 1) / kBM, (g.ncols + kBN - 1) / kBN);
  conv_igemm_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(src),
      static_cast<const __nv_bfloat16*>(wmat),
      static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace igemm
