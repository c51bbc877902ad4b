// Implicit-GEMM convolution core for Hopper (sm_90a): wgmma.mma_async bf16
// with f32 accumulators, the weight operand by TMA and the im2col operand by
// a cp.async gather, in a ring of shared-memory stages governed by
// mbarriers. Serves kernels 2 and 3 (csrc/conv3x3_dil.cu: the train path's
// 3x3 forward and dgrad, the eval path's batched forward) and kernel 5's
// forward and dgrad (csrc/conv4x4_s2.cu); kernel 5's wgrad and the three
// directions of kernel 4 (csrc/conv4x4_patch.cu) are kernels of their own
// built from this file's pieces (the ring, the descriptors, TMA, cp.async,
// the narrow and transposed wgmma shapes).
//
// out[M, Ncols] = A[M, K] @ B[K, Ncols] with A never materialised (row m of
// A is the Cs channels of one source pixel per tap, read from the NHWC
// source, zero padding applied on load), f32 accumulation, an optional f32
// bias added before the one rounding to bf16. The geometry (`Geo`) maps an
// output-grid pixel and a tap to a source pixel and a destination pixel,
// the batch flattened into M (a tile may straddle two images), plus the
// split of K.
//
// What bounds it on the H100, and what the design does about it:
// - At the 3x3 convs and kernel 5's wide shapes (K = 1,152-8,192 against
//   M of 2,048-32,768 pixels) the products bound the call (989 TFLOP/s bf16
//   dense). They run as wgmma m64n128k16 / m64n256k16 from shared memory:
//   two consumer warpgroups on a 128 x 128 or 128 x 256 tile (one on a
//   64 x 128 tile where M is tiny), 64 or 128 f32 accumulators per thread.
//   The caller picks the tile so that the grid still fills the card
//   (ops/kernels/conv3x3_dil.py::tile_plan): the wider tile halves the
//   gather's L2 traffic, but at one image it would leave half the SMs idle.
// - The operands reach the tensor cores through a ring of kStages stages,
//   each one K step of 64 bf16 (one 128-byte swizzle row) of A and B in the
//   128B-swizzled K-major layout that the wgmma descriptors read. A
//   producer warpgroup fills the ring: thread 0 loads B (the K-major weight
//   matrix, (classes, Ncols, K)) by one TMA box per stage, whose 3D tensor
//   map zero-fills columns past Ncols; the 128 threads gather A with 16-byte
//   cp.async (zero size outside the source, so padding and the masked last
//   tile cost no branch), written straight into the swizzled layout, and
//   hand the stage over with cp.async.mbarrier.arrive. The consumers release
//   a stage as soon as the wgmma that read it has retired.
// - At the Warper encoder's deep shapes (M = 8-512, Ncols 512, K 8,192) the
//   tiles cannot fill 132 SMs and the 8.4 MB weight read bounds the call:
//   K is cut into `splits` ranges of `per` K steps (blockIdx.z), each block
//   writes an f32 partial, and csrc/splitk.cuh sums them in split order,
//   adds the bias and rounds once (deterministic).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Internal linkage throughout: each .cu builds its own shared library, and
// an inline function's static (or the function itself) would otherwise be a
// unique symbol that the dynamic loader binds across the loaded libraries.
namespace sm90 {
namespace {

constexpr int kBK = 64;                     // K per stage: one 128-byte row
constexpr int kRowBytes = kBK * 2;

// The ring of a BM x BN tile: as many stages as fit 200 KB, at most 5.
template <int kWG, int kBN>
struct Ring {
  static constexpr int kATileBytes = 64 * kWG * kRowBytes;
  static constexpr int kBTileBytes = kBN * kRowBytes;
  static constexpr int kStages =
      200 * 1024 / (kATileBytes + kBTileBytes) < 5
          ? 200 * 1024 / (kATileBytes + kBTileBytes)
          : 5;
  // 1,024 bytes of slack to align the ring, the ring, 2 * kStages barriers
  static constexpr size_t kSmemBytes =
      1024 + kStages * (kATileBytes + kBTileBytes) + 2 * kStages * 8;
};

// out-grid pixel (n, i, j), n < n images, and tap t = ty * kw + tx:
//   source (n, i*rs + ry + ty*tmul + tadd, j*rs + rx + tx*tmul + tadd) of an
//   (n, sh, sw, cs) NHWC tensor (zero outside);
//   written to (n, i*os + oy, j*os + ox) of an (n, oh_out, ow_out, ncols)
//   NHWC tensor.
// With zpar, blockIdx.z / splits = 2*py + px selects a parity class: ry +=
// py, rx += px, oy = py, ox = px, and B is that class's (ncols, K) matrix.
// blockIdx.z % splits selects K steps [split * per, split * per + per); with
// splits > 1 the block writes f32 partials to ws[split][m][col] (os == 1,
// zpar == 0 only) and a second pass finishes the output.
struct Geo {
  int n, oh, ow;          // output grid: rows of A = n * oh * ow
  int sh, sw, cs;         // source tensor
  int kw, taps;           // taps per kernel row, taps in all
  int rs, ry, rx;         // source base = (i * rs + ry, j * rs + rx)
  int tmul, tadd;         // tap offset = t{y,x} * tmul + tadd
  int os, oh_out, ow_out; // destination pixel = (i * os + oy, j * os + ox)
  int ncols;              // output channels (columns of B)
  int zpar;               // 1: blockIdx.z carries a parity class
  int splits, per;        // K ranges, and K steps in each
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Arrive on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4 bytes, zero-filled where !pred (cached in L1: neighbours reread it).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128B-swizzled layout: rows of
// 128 bytes, 8-row atoms of 1,024 bytes (stride byte offset), 1,024-aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// wgmma descriptor of an MN-major tile in the 128B-swizzled layout: 64
// consecutive M (or N) values of one K index fill a 128-byte row, 8 K
// indices make a 1,024-byte atom (stride byte offset: the next 8 K), and
// the next 64 M (or N) values lie `mn_stride` bytes on (leading byte
// offset). The layout CUTLASS's make_gmma_desc builds for Major::MN with
// SW128: ((8, 8, m), (8, k)) : ((1, 8, LBO), (64, SBO)) in elements.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr,
                                                  uint32_t mn_stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((mn_stride & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128]^T, both K-major in shared memory
// (kTrans 0), or both MN-major (kTrans 1: imm-trans-a and imm-trans-b).
template <int kTrans = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  // scale-d 1: accumulate
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

// d[64 x 256] += A[64 x 16] @ B[16 x 256]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"  // scale-d 1: accumulate
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64]^T, both K-major (kTrans 0) or both
// MN-major (kTrans 1).
template <int kTrans = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"  // scale-d 1: accumulate
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

// d[64 x 32] += A[64 x 16] @ B[16 x 32]^T, both K-major.
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"  // scale-d 1: accumulate
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <int kBN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db) {
  if constexpr (kBN == 256)
    wgmma_m64n256k16(d, da, db);
  else
    wgmma_m64n128k16(d, da, db);
}

// kWG consumer warpgroups, each 64 rows of the BM = 64 * kWG row tile and
// all kBN columns, and one producer warpgroup (warpgroup 0).
template <int kWG, int kBN>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap tmap_b,
                 const __nv_bfloat16* __restrict__ src,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                 const Geo g) {
  using R = Ring<kWG, kBN>;
  constexpr int BM = 64 * kWG;
  constexpr int kStages = R::kStages;
  constexpr int kATileBytes = R::kATileBytes, kBTileBytes = R::kBTileBytes;
  extern __shared__ uint8_t sm90_smem[];
  const uint32_t raw = smem_u32(sm90_smem);
  const uint32_t sA = (raw + 1023) & ~1023u;
  const uint32_t sB = sA + kStages * kATileBytes;
  const uint32_t full = sB + kStages * kBTileBytes;  // full[s] = full + 8 s
  const uint32_t empty = full + kStages * 8;

  const int tid = threadIdx.x;
  const int M = g.n * g.oh * g.ow;
  const int KT = g.taps * g.cs / kBK;
  const int cls = blockIdx.z / g.splits;
  const int split = blockIdx.z - cls * g.splits;
  const int kt0 = split * g.per;
  const int kt1 = min(KT, kt0 + g.per);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  int ry = g.ry, rx = g.rx, oy = 0, ox = 0;
  if (g.zpar) {
    ry += cls >> 1;
    rx += cls & 1;
    oy = cls >> 1;
    ox = cls & 1;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128 + 1);  // 128 cp.async arrivals + the TMA's
      mbar_init(empty + 8 * s, 128 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: thread (chunk, r0) gathers 16 bytes of rows r0 + 16 i.
    constexpr int kRows = BM / 16;
    const int chunk = tid & 7, r0 = tid >> 3;
    int a_n[kRows], a_y[kRows], a_x[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + r0 + 16 * i;
      const int mm = m < M ? m : 0;
      const int j = mm % g.ow, t = mm / g.ow;
      a_n[i] = (t / g.oh) * g.sh;
      a_y[i] = m < M ? (t % g.oh) * g.rs + ry : -(1 << 30);  // masked row
      a_x[i] = j * g.rs + rx;
    }
    // 128B swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
    const uint32_t a_dst = r0 * kRowBytes + ((chunk ^ (r0 & 7)) << 4);
    for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(full + 8 * s, kBTileBytes);
        tma_load_3d(sB + s * kBTileBytes, &tmap_b, full + 8 * s, kt * kBK, n0,
                    cls);
      }
      const int k0 = kt * kBK;
      const int tap = k0 / g.cs;
      const int c0 = k0 - tap * g.cs + chunk * 8;
      const int offy = (tap / g.kw) * g.tmul + g.tadd;
      const int offx = (tap % g.kw) * g.tmul + g.tadd;
      const uint32_t dst = sA + s * kATileBytes + a_dst;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int y = a_y[i] + offy, x = a_x[i] + offx;
        const bool ok = y >= 0 && y < g.sh && x >= 0 && x < g.sw;
        const __nv_bfloat16* p =
            ok ? src + (static_cast<size_t>(a_n[i] + y) * g.sw + x) * g.cs + c0
               : src;
        cp_async16(dst + i * 16 * kRowBytes, p, ok);
      }
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: warpgroup cw computes rows [cw * 64, cw * 64 + 64).
  const int cw = (tid >> 7) - 1;
  float acc[kBN / 2];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.0f;
  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    // The gather wrote through the generic proxy; wgmma reads through the
    // async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgmma_fence();
    const uint64_t da = desc_sw128(sA + s * kATileBytes + cw * 64 * kRowBytes);
    const uint64_t db = desc_sw128(sB + s * kBTileBytes);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes along K per step
      wgmma_k16<kBN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products have retired
    if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();

  // Epilogue. acc[4 j + 2 h + e] is row warp * 16 + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x kBN tile.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (m >= M) continue;
    const int j = m % g.ow, t = m / g.ow;
    const size_t pix = (static_cast<size_t>(t / g.oh) * g.oh_out +
                        (t % g.oh) * g.os + oy) * g.ow_out + j * g.os + ox;
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const int col = n0 + 8 * jj + 2 * (lane & 3);
      if (col >= g.ncols) continue;
      float v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
      if (g.splits > 1) {
        *reinterpret_cast<float2*>(
            ws + (static_cast<size_t>(split) * M + m) * g.ncols + col) =
            make_float2(v0, v1);
      } else {
        if (bias != nullptr) {
          v0 += bias[col];
          v1 += bias[col + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(out + pix * g.ncols + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (the
// library does not link libcuda); null if the runtime cannot give it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3D bf16 tensor map with 128B swizzle over a (d2, d1, d0) row-major
// array (d0 innermost), boxes of (1, box1, box0); out-of-range elements
// load as zero. Returns a cudaError_t.
inline int encode_map_3d(CUtensorMap* map, const void* base, uint64_t d0,
                         uint64_t d1, uint64_t d2, uint32_t box0,
                         uint32_t box1) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidDeviceFunction);
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Set `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device once: bit d of `done` records device ordinal d (the attribute is
// per device, and a process may launch on more than one). Returns a
// cudaError_t.
int smem_once_per_device(const void* kernel, size_t bytes,
                         std::atomic<unsigned long long>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done->load() & bit)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done->fetch_or(bit);
  return static_cast<int>(err);
}

template <int kWG, int kBN>
int launch_wg(const CUtensorMap& map, const void* src, const void* bias,
              void* out, void* ws, const Geo& g, int classes,
              cudaStream_t stream) {
  constexpr size_t bytes = Ring<kWG, kBN>::kSmemBytes;
  static std::atomic<unsigned long long> configured{0};
  const int err = smem_once_per_device(
      reinterpret_cast<const void*>(conv_sm90_kernel<kWG, kBN>), bytes,
      &configured);
  if (err) return err;
  const int BM = 64 * kWG;
  const int M = g.n * g.oh * g.ow;
  const dim3 grid((M + BM - 1) / BM, (g.ncols + kBN - 1) / kBN,
                  classes * g.splits);
  conv_sm90_kernel<kWG, kBN><<<grid, 128 * (kWG + 1), bytes, stream>>>(
      map, static_cast<const __nv_bfloat16*>(src),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), g);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`. bt: the K-major weights, (classes, g.ncols, K) bf16
// with K = taps * cs, classes = 4 when g.zpar else 1; bias: (ncols,) f32 or
// null; the tile bm x bn: 128 x 128, 64 x 128 where M is tiny, or
// 128 x 256 where the columns are many; with g.splits > 1, ws holds
// (splits, M, ncols) f32 partials and `out` is not written (the caller runs
// the second pass). cs % 64 == 0, ncols % 8 == 0. Returns a cudaError_t.
inline int launch(const void* src, const void* bt, const void* bias, void* out,
                  void* ws, const Geo& g, int bm, int bn,
                  cudaStream_t stream) {
  const int K = g.taps * g.cs;
  const int KT = K / kBK;
  const int classes = g.zpar ? 4 : 1;
  if (g.cs % kBK || g.ncols % 8 || g.splits < 1 || g.per < 1 ||
      static_cast<long long>(g.splits) * g.per < KT ||
      (g.splits - 1) * g.per >= KT ||
      (g.splits > 1 && (g.zpar || g.os != 1 || ws == nullptr)) ||
      !((bm == 128 && (bn == 128 || bn == 256)) || (bm == 64 && bn == 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = encode_map_3d(&map, bt, K, g.ncols, classes, kBK, bn);
  if (err) return err;
  if (bm == 64)
    return launch_wg<1, 128>(map, src, bias, out, ws, g, classes, stream);
  if (bn == 256)
    return launch_wg<2, 256>(map, src, bias, out, ws, g, classes, stream);
  return launch_wg<2, 128>(map, src, bias, out, ws, g, classes, stream);
}

}  // namespace
}  // namespace sm90
