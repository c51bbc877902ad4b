// Deterministic second pass of a split-K reduction: out[e] = sum over s of
// ws[s * count + e], summed in split order (no atomics). `sum_splits` ends
// in f32 (the wgrad kernels of csrc/conv4x4_s2.cu and csrc/conv4x4_patch.cu);
// `sum_splits_bf16` adds an f32 bias per column after the sum and rounds
// once to bf16 (kernel 5's split-K forward, csrc/igemm_sm90.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Internal linkage throughout: each .cu builds its own shared library, and
// an inline function's static (or the function itself) would otherwise be a
// unique symbol that the dynamic loader binds across the loaded libraries.
namespace splitk {
namespace {

__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int splits,
                                  long long count) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < count; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += ws[k * count + e];
    out[e] = s;
  }
}

inline int sum_splits(const float* ws, float* out, int splits,
                      long long count, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (count + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<static_cast<int>(blocks), threads, 0, stream>>>(
      ws, out, splits, count);
  return static_cast<int>(cudaGetLastError());
}

// ws: (splits, count / cols, cols) f32; bias: (cols,) f32 or null.
__global__ void sum_splits_bf16_kernel(const float* __restrict__ ws,
                                       const float* __restrict__ bias,
                                       __nv_bfloat16* __restrict__ out,
                                       int splits, long long count, int cols) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < count; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += ws[k * count + e];
    if (bias != nullptr) s += bias[e % cols];
    out[e] = __float2bfloat16_rn(s);
  }
}

inline int sum_splits_bf16(const float* ws, const float* bias,
                           __nv_bfloat16* out, int splits, long long count,
                           int cols, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (count + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_splits_bf16_kernel<<<static_cast<int>(blocks), threads, 0, stream>>>(
      ws, bias, out, splits, count, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace splitk
