// Fused align-corners bilinear upsample + first-index channel argmax -> uint8.
//
// Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/upsample_argmax.py
// (`upsample_argmax`, Pallas `_kernel`), the eval tail: (N, h, w, C) NHWC
// logits (64x128x19 at the eval shape) -> (N, H, W) uint8 masks
// (1024x2048). The unfused tail writes and re-reads an (N, H, W, C) f32
// tensor (160 MB per image at the eval shape) only to reduce it to 2 MB.
//
// Bound on the H100: the function moves ~2.4 MB (0.31 MB bf16 in, 2.1 MB
// out), under a microsecond at 3.35 TB/s, while its ~1.7e8 f32 lerp and
// compare operations run on CUDA cores (no tensor-core form), so it is bound
// by operations: per output pixel and channel a mul, an fma and a compare.
// The design keeps the instructions near that count:
//   * a block covers rows_per_block output rows (2, or 1 where two rows of
//     labels do not fit in shared memory) of one image;
//   * a thread owns the run of output pixels that lie between one pair of
//     source columns (i0 = j, i1 = min(j + 1, w - 1), or j where w or W is
//     1, as the tables have it; ~16 pixels at the eval shape, from the table
//     of run starts); it lerps the pair's two columns in height into
//     registers, kW channels at a time, and, per pixel, computes its width
//     weights and does the width lerp and the compare per channel with no
//     further load. There is no staging phase and no barrier before the
//     compute, so one warp's loads overlap another's compares;
//   * the chunk width kW is the least of 8, 12, 16, 19, 24, 32, 40, 48, 64
//     that holds C (19 for the 19 classes of Cityscapes); a larger C runs in
//     equal chunks of at most 64 (ops/kernels/upsample_argmax.py::chunk_width),
//     and each pixel's best value so far waits in shared memory between
//     chunks. A chunk of fewer channels repeats its first channel in the
//     remaining registers, which never wins under the strict compare. Where
//     a column's C channels fill whole 16-byte words (C a multiple of 4 in
//     f32, of 8 in bf16), a full chunk loads 16 bytes at a time (scalar
//     loads of lanes 64 or 128 bytes apart ran at half speed). The widths
//     come from scripts/argmax_channel_sweep.py: a padded channel costs its
//     compares, a wider chunk's registers cost occupancy;
//   * the labels go to a shared row buffer, and the block writes its rows
//     to device memory as 16-byte vectors (bytes where W % 16 != 0).
// Nothing carries between blocks (the TPU kernel's sequential grid and its
// grid-step-0 scratch do not translate).
//
// Numerics: interpolation in f32 for bf16 and f32 input. The weights are
// those of ops/resize.py::_interp_matrix bit for bit: the row tables (i0, i1,
// w0, w1 per output row) come from the wrapper, and each output column's
// weights are computed here by the same f64 formula (src = x * s, frac =
// src - i0, w1 = f32(frac), w0 = f32(1 - frac)). Each 2-tap lerp is
// fmaf(w1, x1, w0 * x0), the order of a k-ascending matmul accumulation, H
// first, then W, as the plain path. The running max uses a strict `>` so
// the FIRST maximal channel wins (torch/numpy argmax).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxW = 64;  // the widest chunk of channels held in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lerp2(float w0, float x0, float w1,
                                       float x1) {
  return fmaf(w1, x1, __fmul_rn(w0, x0));
}

// One column's chunk of kW channels of source rows x0 and x1 (p0, p1 at
// channel c0), lerped in height into v; past the chunk's nc channels, its
// first again. vec: a full chunk whose columns are 16-byte aligned (C
// channels a multiple of 16 bytes), loaded 16 bytes at a time.
template <int kW>
__device__ __forceinline__ void lerp_chunk(const float* p0, const float* p1,
                                           float u0, float u1, int nc, bool vec,
                                           float (&v)[kW]) {
  if constexpr (kW % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < kW / 4; ++q) {
        const float4 a = reinterpret_cast<const float4*>(p0)[q];
        const float4 b = reinterpret_cast<const float4*>(p1)[q];
        v[4 * q] = lerp2(u0, a.x, u1, b.x);
        v[4 * q + 1] = lerp2(u0, a.y, u1, b.y);
        v[4 * q + 2] = lerp2(u0, a.z, u1, b.z);
        v[4 * q + 3] = lerp2(u0, a.w, u1, b.w);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) v[k] = k < nc ? lerp2(u0, p0[k], u1, p1[k]) : v[0];
}

template <int kW>
__device__ __forceinline__ void lerp_chunk(const __nv_bfloat16* p0,
                                           const __nv_bfloat16* p1, float u0,
                                           float u1, int nc, bool vec,
                                           float (&v)[kW]) {
  if constexpr (kW % 8 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < kW / 8; ++q) {
        const uint4 a = reinterpret_cast<const uint4*>(p0)[q];
        const uint4 b = reinterpret_cast<const uint4*>(p1)[q];
        const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // bf16 pairs widened exactly
          v[8 * q + 2 * e] = lerp2(u0, __uint_as_float(wa[e] << 16), u1,
                                   __uint_as_float(wb[e] << 16));
          v[8 * q + 2 * e + 1] = lerp2(u0, __uint_as_float(wa[e] & 0xffff0000u), u1,
                                       __uint_as_float(wb[e] & 0xffff0000u));
        }
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    v[k] = k < nc ? lerp2(u0, to_f32(p0[k]), u1, to_f32(p1[k])) : v[0];
  }
}

// The pixels [lo, hi) of source column j's run over one chunk of channels
// c0.. (a, b: the chunk's pair of columns lerped in height): per pixel its
// width weights, then the width lerp and the strict compare per channel.
// kMerge (C > kW): the pixel's best so far waits in `kept` between chunks,
// and an earlier chunk's wins ties.
template <int kW, bool kMerge>
__device__ __forceinline__ void run_chunk(const float (&a)[kW],
                                          const float (&b)[kW], int lo,
                                          int hi, double sx, int j, int c0,
                                          bool last, uint8_t* lab, float* kept) {
  const double dj = j;
  double src = static_cast<double>(lo);
#pragma unroll 2
  for (int ox = lo; ox < hi; ++ox, src += 1.0) {
    const double frac = __dmul_rn(src, sx) - dj;  // two roundings, as numpy
    const float v0 = __double2float_rn(1.0 - frac), v1 = __double2float_rn(frac);
    float best = lerp2(v0, a[0], v1, b[0]);
    int arg = 0;
#pragma unroll
    for (int k = 1; k < kW; ++k) {
      const float y = lerp2(v0, a[k], v1, b[k]);
      if (y > best) {
        best = y;
        arg = k;
      }
    }
    if constexpr (kMerge) {
      arg += c0;
      if (c0 > 0 && !(best > kept[ox])) {
        best = kept[ox];
        arg = lab[ox];
      }
      if (!last) kept[ox] = best;
    }
    lab[ox] = static_cast<uint8_t>(arg);
  }
}

// idx: [row i0 (oh) | row i1 (oh) | run start (w + 1): the first output
//       column with i0 >= j] int32
// wt:  [row w0 (oh) | row w1 (oh)] f32; sx = (w - 1) / (ow - 1) in f64 (0
//      where w or ow is 1).
// Shared memory: the labels (rows_per_block x ow uint8), then, where
// kMerge (C > kMaxW, in chunks of kW), the best value so far
// (rows_per_block x ow f32, 16-aligned). Without kMerge, C <= kW.
template <typename T, int kW, bool kMerge>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                       const int* __restrict__ idx,
                       const float* __restrict__ wt, double sx, int h, int w,
                       int c, int oh, int ow, int rows_per_block) {
  extern __shared__ __align__(16) uint8_t labels[];  // (row, ow)
  float* best_so_far = reinterpret_cast<float*>(
      labels + (rows_per_block * ow + 15) / 16 * 16);
  const int n = blockIdx.y;
  const int oy0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, oh - oy0);
  const int span = w * c;
  const int* start = idx + 2 * oh;

  const int per_row = kThreads / rows_per_block;
  const int r = threadIdx.x / per_row;
  if (r < nr) {
    const int oy = oy0 + r;
    const float u0 = wt[oy], u1 = wt[oh + oy];
    const T* x0 = x + (static_cast<size_t>(n) * h + idx[oy]) * span;
    const T* x1 = x + (static_cast<size_t>(n) * h + idx[oh + oy]) * span;
    const bool aligned = (c * sizeof(T)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0;
    uint8_t* lab = labels + r * ow;
    float* kept = best_so_far + r * ow;
    for (int j = threadIdx.x - r * per_row; j < w; j += per_row) {
      const int lo = start[j], hi = start[j + 1];
      if (lo >= hi) continue;
      const int ka = j * c, kb = (sx == 0.0 ? j : min(j + 1, w - 1)) * c;
      for (int c0 = 0; c0 < (kMerge ? c : 1); c0 += kW) {
        // The chunk's pair of columns lerped in height, in registers.
        const int nc = min(kW, c - c0);
        const bool vec = aligned && nc == kW;
        float a[kW], b[kW];
        lerp_chunk<kW>(x0 + ka + c0, x1 + ka + c0, u0, u1, nc, vec, a);
        lerp_chunk<kW>(x0 + kb + c0, x1 + kb + c0, u0, u1, nc, vec, b);
        run_chunk<kW, kMerge>(a, b, lo, hi, sx, j, c0, c0 + kW >= c, lab, kept);
      }
    }
  }
  __syncthreads();

  uint8_t* orow = out + (static_cast<size_t>(n) * oh + oy0) * ow;  // nr rows
  const int total = nr * ow;
  if (ow % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    for (int q = threadIdx.x; q < total / 16; q += kThreads) {
      reinterpret_cast<uint4*>(orow)[q] = reinterpret_cast<const uint4*>(labels)[q];
    }
  } else {
    for (int q = threadIdx.x; q < total; q += kThreads) orow[q] = labels[q];
  }
}

// Shared memory of a block: its rows of labels and, where C > kMaxW, of
// best values.
size_t smem_bytes(int c, int ow, int rows_per_block) {
  const size_t px = static_cast<size_t>(rows_per_block) * ow;
  return c > kMaxW ? (px + 15) / 16 * 16 + px * sizeof(float) : px;
}

// The kernel for c channels: one chunk of the least width that holds c, or,
// for c > kMaxW, chunks of the least width that holds an equal share of
// ceil(c / kMaxW) chunks (at least 33 channels: 40, 48 or 64).
template <typename T>
decltype(&upsample_argmax_kernel<T, kMaxW, false>) kernel_for(int c) {
  if (c <= 8) return upsample_argmax_kernel<T, 8, false>;
  if (c <= 12) return upsample_argmax_kernel<T, 12, false>;
  if (c <= 16) return upsample_argmax_kernel<T, 16, false>;
  if (c <= 19) return upsample_argmax_kernel<T, 19, false>;
  if (c <= 24) return upsample_argmax_kernel<T, 24, false>;
  if (c <= 32) return upsample_argmax_kernel<T, 32, false>;
  if (c <= 40) return upsample_argmax_kernel<T, 40, false>;
  if (c <= 48) return upsample_argmax_kernel<T, 48, false>;
  if (c <= kMaxW) return upsample_argmax_kernel<T, kMaxW, false>;
  const int chunks = (c + kMaxW - 1) / kMaxW;
  const int share = (c + chunks - 1) / chunks;
  if (share <= 40) return upsample_argmax_kernel<T, 40, true>;
  if (share <= 48) return upsample_argmax_kernel<T, 48, true>;
  return upsample_argmax_kernel<T, kMaxW, true>;
}

template <typename T>
int launch(const void* x, void* out, const void* idx, const void* wt,
           double sx, int n, int h, int w, int c, int oh, int ow,
           int rows_per_block, cudaStream_t stream) {
  const size_t smem = smem_bytes(c, ow, rows_per_block);
  auto kernel = kernel_for<T>(c);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((oh + rows_per_block - 1) / rows_per_block, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(out),
      static_cast<const int*>(idx), static_cast<const float*>(wt), sx, h, w, c,
      oh, ow, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, h, w, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// out: (n, oh, ow) uint8; idx, wt, sx: the tables and scale above;
// rows_per_block: 1 or 2 output rows per block (the wrapper checks the
// shared memory, `smem_bytes`). Returns the launch's cudaError_t (0 = success).
extern "C" int asn_upsample_argmax(const void* x, int is_bf16, void* out,
                                   const void* idx, const void* wt, double sx,
                                   int n, int h, int w, int c, int oh, int ow,
                                   int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, out, idx, wt, sx, n, h, w, c, oh, ow,
                                 rows_per_block, s);
  }
  return launch<float>(x, out, idx, wt, sx, n, h, w, c, oh, ow,
                       rows_per_block, s);
}
