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
// by operations. The design keeps the operation count near the minimum:
//   * one block per segment of one output row; the row's two source rows
//     are lerped in height ONCE per needed source column and channel into
//     shared memory (f32), so the per-pixel work is the width lerp and the
//     compare: 2 shared loads, a mul and an fma, and a compare per channel;
//   * one thread per output pixel of the segment, uint8 written directly.
// Nothing carries between blocks (the TPU kernel's sequential grid and its
// grid-step-0 scratch do not translate).
//
// Numerics: interpolation in f32 for bf16 and f32 input. The weight tables
// (i0, i1, w0, w1 per output row and per output column) come from the
// wrapper, built from the same f64 formula as ops/resize.py::_interp_matrix,
// so the weights are bit-identical to the plain path's. Each 2-tap lerp is
// fmaf(w1, x1, w0 * x0), the order of a k-ascending matmul accumulation, H
// first, then W, as the plain path. The running max uses a strict `>` so
// the FIRST maximal channel wins (torch/numpy argmax).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegment = 1024;  // output pixels of one row per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lerp2(float w0, float x0, float w1,
                                       float x1) {
  return fmaf(w1, x1, __fmul_rn(w0, x0));
}

// idx: [row i0 (oh) | row i1 (oh) | col i0 (ow) | col i1 (ow)] int32
// wt:  [row w0 (oh) | row w1 (oh) | col w0 (ow) | col w1 (ow)] f32
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                       const int* __restrict__ idx,
                       const float* __restrict__ wt, int h, int w, int c,
                       int oh, int ow) {
  extern __shared__ float rows[];  // height-lerped rows, (j - j_lo) * c + ch
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  const int seg0 = blockIdx.x * kSegment;
  const int seg1 = min(seg0 + kSegment, ow);
  const int* col_i0 = idx + 2 * oh;
  const int* col_i1 = col_i0 + ow;
  const float* col_w0 = wt + 2 * oh;
  const float* col_w1 = col_w0 + ow;

  // Source columns this segment reads: the tables are nondecreasing, so
  // they span [col_i0[seg0], col_i1[seg1 - 1]], contiguous in NHWC.
  const int j_lo = col_i0[seg0];
  const int span = (col_i1[seg1 - 1] - j_lo + 1) * c;
  const float u0 = wt[oy], u1 = wt[oh + oy];
  const T* x0 = x + ((static_cast<size_t>(n) * h + idx[oy]) * w + j_lo) * c;
  const T* x1 =
      x + ((static_cast<size_t>(n) * h + idx[oh + oy]) * w + j_lo) * c;
  for (int k = threadIdx.x; k < span; k += kThreads) {
    rows[k] = lerp2(u0, to_f32(x0[k]), u1, to_f32(x1[k]));
  }
  __syncthreads();

  uint8_t* orow = out + (static_cast<size_t>(n) * oh + oy) * ow;
  for (int ox = seg0 + threadIdx.x; ox < seg1; ox += kThreads) {
    const float* a = rows + (col_i0[ox] - j_lo) * c;
    const float* b = rows + (col_i1[ox] - j_lo) * c;
    const float v0 = col_w0[ox], v1 = col_w1[ox];
    float best = lerp2(v0, a[0], v1, b[0]);
    int arg = 0;
    for (int ch = 1; ch < c; ++ch) {
      const float y = lerp2(v0, a[ch], v1, b[ch]);
      if (y > best) {
        best = y;
        arg = ch;
      }
    }
    orow[ox] = static_cast<uint8_t>(arg);
  }
}

template <typename T>
int launch(const void* x, void* out, const void* idx, const void* wt, int n,
           int h, int w, int c, int oh, int ow, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(w) * c * sizeof(float);
  auto kernel = upsample_argmax_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((ow + kSegment - 1) / kSegment, oh, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(out),
      static_cast<const int*>(idx), static_cast<const float*>(wt), h, w, c, oh,
      ow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, h, w, c) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// out: (n, oh, ow) uint8. Returns the launch's cudaError_t (0 = success).
extern "C" int asn_upsample_argmax(const void* x, int is_bf16, void* out,
                                   const void* idx, const void* wt, int n,
                                   int h, int w, int c, int oh, int ow,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, out, idx, wt, n, h, w, c, oh, ow, s);
  }
  return launch<float>(x, out, idx, wt, n, h, w, c, oh, ow, s);
}
