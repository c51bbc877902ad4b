// The discriminator's conv1: torch Conv2d(C, 64, k=4, s=2, p=1) over the
// planar (N, C, H, W) softmax map (C = 19), bf16 in, f32 accumulation;
// forward (NHWC bf16 out + f32 bias), wgrad (f32) and dgrad (planar bf16).
//
// Replaces the TPU kernel adaptsegnet_tpu/ops/pallas/conv4x4_patch.py
// (`conv4x4_s2_phases_planar`: `_fwd_kernel`, `_wgrad_kernel`,
// `_dgrad_kernel`). The TPU version consumes four stride-2 parity phases of
// the padded map, a layout chosen for the TPU's 128-lane tiles. Here the
// kernels read the dense planar map directly, the conv padding applied on
// load, on the Hopper core's pieces (csrc/igemm_sm90.cuh: wgmma from
// 128B-swizzled shared memory, TMA, cp.async, mbarrier rings).
//
// What bounds it on the H100: each direction moves ~36.7 MB (19.9 MB of bf16
// map, 16.8 MB of NHWC dy or output) for 5.10 GFLOP, so bytes bound it
// (10.97 us at 3.35 TB/s). With N = 64 (forward, wgrad) or 19 (dgrad) the
// products are few; what costs is turning the planar map into patch rows
// (forward, wgrad) and gathering dy (dgrad), and the synchronisation per
// K step. The design:
// - One planar patch producer serves the forward and the wgrad. K is ordered
//   (c, ky, kx), 16*C = 304 values padded to five K steps of 64: one
//   128-byte swizzle row holds one output pixel's 64 values for four
//   channels, and its 16-byte chunk q is channel q/2, kernel rows 2(q%2) and
//   2(q%2)+1, column taps 0..3. A unit is one K step of a row segment of P
//   pixels: the four map rows 2i-1 .. 2i+2 of four channels, map columns
//   2j0-8 .. 2j0+2P+7, staged into shared memory several units ahead by TMA
//   boxes of a 4D tensor map over (W, H, C, N), whose zero fill is the conv
//   padding and the channels past C (4-byte cp.async where W % 8 != 0). Two
//   producer warpgroups then assemble each chunk from three words per map
//   row (byte_perm picks columns 2j-1 .. 2j+2) and write it at chunk q ^ (m
//   % 8) of row m. That row is at once the forward's K-major A row and the
//   wgrad's MN-major operand row for K index = pixel m. One named barrier
//   per unit carries the producer's synchronisation: one warp waits for a
//   free ring stage and one thread hands a built one over. The producer is
//   bound by its instructions (one warp per scheduler), so the staging
//   costs it none: TMA, and the build loads a thread's words before it
//   stores.
// - Forward: a persistent implicit GEMM (M = N*Ho*Wo in row segments of 128
//   pixels, K = 320, N = 64) whose 40 KB of K-major weights come by TMA
//   once per block and stay resident (TMA zero-fills K past 16*C); two
//   consumer warpgroups run wgmma m64n64k16 on a six-stage A ring, and each
//   stages its 64 x 64 bf16 tile (bias added in f32 before the one rounding)
//   in shared memory so that the NHWC rows leave in coalesced 16-byte stores
//   while the producer already fills the next tile.
// - Dgrad: the parity-class form of kernel 5's dgrad (csrc/conv4x4_s2.cu):
//   dx pixel (2p + py, 2q + px) takes taps ky = 1 - py + 2a, kx = 1 - px + 2b
//   from dy pixel (p + py - a, q + px - b), so K = 4 taps x 64 channels with
//   no zero tap. A block's tile is 64 q-columns of one dx row in both column
//   parities (one consumer warpgroup each, wgmma m64n32k16: C = 19 padded to
//   32 by TMA's zero fill), so the planar epilogue writes each channel's run
//   of 128 dx columns once. The four classes' K-major weights (64 KB) stay
//   resident; A is the core's 16-byte cp.async gather of NHWC dy, whose L2
//   traffic (4 taps x 2 parities re-read each dy row) bounds it.
// - Wgrad: dW (320 x 64) = sum over pixels of patch (x) dy, both operands
//   MN-major as in kernel 5's wgrad: per K step of 64 pixels (one row
//   segment) the producer builds all five 64-row chunks of the patch once
//   and TMA brings the 64 x 64 dy box, so x and dy are each read once. The
//   pixel steps are split into as many ranges as one wave holds (the
//   wrapper's `wgrad_plan`), one f32 partial each, summed in split order by
//   csrc/splitk.cuh: deterministic, f32 out.

#include "igemm_sm90.cuh"
#include "splitk.cuh"

namespace {

// Using-declarations, not a using-directive: the directive would make this
// file's anonymous namespace ambiguous with sm90's in nvcc's host stub.
using sm90::bar_sync;
using sm90::cp_async16;
using sm90::cp_async4;
using sm90::cp_async_arrive;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::desc_mn_sw128;
using sm90::desc_sw128;
using sm90::encode_map_3d;
using sm90::fence_proxy_async;
using sm90::kRowBytes;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_3d;
using sm90::tma_load_4d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_m64n32k16;
using sm90::wgmma_m64n64k16;
using sm90::wgmma_wait;

constexpr int kCout = 64;                    // output channels (D's ndf)
constexpr int kKSteps = 5;                   // 16 * C <= 320: five K steps
constexpr int kChunkBytes = 64 * kRowBytes;  // 64 rows of one K step: 8 KB
constexpr int kProducers = 256;              // the patch producer's threads
constexpr int kConsumerWarps = 8;            // two consumer warpgroups

// One arrival per warp on `bar`, once all its lanes got here (the empty
// barriers count warps, not threads).
__device__ __forceinline__ void arrive_warp(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// ------------------------------------------------ the planar patch producer

// A row segment of one output row: image n, output row i, columns j0 ..
// j0 + cnt - 1 (cnt <= P, the segment's pixel slots).
struct Seg {
  int n, i, j0, cnt;
};

// The segments sg0, sg0 + stride, sg0 + 2 stride, ... of row segments of P
// pixels: decoded once, then stepped without a division (per_row = ceil(Wo /
// P) segments per output row, Ho rows per image).
template <int P>
struct SegWalk {
  int per_row, ho, wo, dj, drow;  // the step: dj segments and drow rows
  int jt, i, n;                   // the current segment
  __device__ __forceinline__ SegWalk(int sg0, int stride, int ho_, int wo_)
      : per_row((wo_ + P - 1) / P), ho(ho_), wo(wo_) {
    dj = stride % per_row;
    drow = stride / per_row;
    const int row = sg0 / per_row;
    jt = sg0 - row * per_row;
    n = row / ho;
    i = row - n * ho;
  }
  __device__ __forceinline__ Seg get() const {
    return Seg{n, i, jt * P, min(P, wo - jt * P)};
  }
  __device__ __forceinline__ void next() {
    jt += dj;
    int rows = drow;
    if (jt >= per_row) {
      jt -= per_row;
      ++rows;
    }
    i += rows;
    while (i >= ho) {
      i -= ho;
      ++n;
    }
  }
};

// One unit of the producer: channels 4g .. 4g + 3 of a segment of P pixels.
// Its staged map rows: 16 rows rr (channel 4g + rr / 4, map row 2i - 1 +
// rr % 4) of P + 8 four-byte words, word u holding map columns 2j0 - 8 + 2u
// and + 1. They lie as the TMA boxes that stage them, a box row holding at
// most 256 columns: word u of row rr at box u / kBoxWords, row rr, word
// u % kBoxWords.
template <int P>
struct Unit {
  static constexpr int kWords = P + 8;
  static constexpr int kBoxes = 2 * kWords > 256 ? 2 : 1;
  static constexpr int kBoxWords = kWords / kBoxes;     // 68 (P 128), 72 (P 64)
  static constexpr int kBoxBytes = 16 * kBoxWords * 4;  // a multiple of 128
  static constexpr int kRawBytes = kBoxes * kBoxBytes;
  static constexpr int kChunks = P * 8 / kProducers;  // 16-byte chunks per thread
  static_assert(kWords % kBoxes == 0 && kBoxBytes % 128 == 0, "box layout");

  __device__ static __forceinline__ int offset(int rr, int u) {
    return (u / kBoxWords) * kBoxBytes + (rr * kBoxWords + u % kBoxWords) * 4;
  }
};

// Stage unit (s, g) by TMA into `raw` (thread 0): the planar map's 4D tensor
// map (W, H, C, N) zero-fills rows -1 and H, columns outside [0, W) and
// channels >= C, which is the conv's padding.
template <int P>
__device__ __forceinline__ void stage_tma(uint32_t raw, const CUtensorMap* map,
                                          uint32_t bar, const Seg& s, int g) {
  using U = Unit<P>;
  mbar_expect_tx(bar, U::kRawBytes);
  for (int b = 0; b < U::kBoxes; ++b)
    tma_load_4d(raw + b * U::kBoxBytes, map, bar,
                2 * s.j0 - 8 + 2 * b * U::kBoxWords, 2 * s.i - 1, 4 * g, s.n);
}

// The same by 4-byte cp.async (every producer thread), where TMA cannot
// take the map (W % 8 != 0 or x not 16-byte aligned; W is even).
template <int P>
__device__ __forceinline__ void stage_words(uint32_t raw,
                                            const __nv_bfloat16* __restrict__ x,
                                            const Seg& s, int g, int c, int h,
                                            int w, int tid) {
  constexpr int kWords = Unit<P>::kWords;
  for (int idx = tid; idx < 16 * kWords; idx += kProducers) {
    const int rr = idx / kWords, u = idx - rr * kWords;
    const int ch = 4 * g + (rr >> 2);
    const int y = 2 * s.i - 1 + (rr & 3);
    const int col = 2 * s.j0 - 8 + 2 * u;
    const bool ok = ch < c && y >= 0 && y < h && col >= 0 && col < w;
    const __nv_bfloat16* p =
        ok ? x + ((static_cast<size_t>(s.n) * c + ch) * h + y) * w + col : x;
    cp_async4(raw + Unit<P>::offset(rr, u), p, ok);
  }
}

// Build the unit's 64-column K chunk of the patch matrix at `dst`: row m
// (pixel j0 + m) of 128 bytes, its chunk q (channel 4g + q/2, kernel rows
// 2(q%2) and 2(q%2) + 1, column taps 0..3 = map columns 2j - 1 .. 2j + 2)
// at chunk q ^ (m % 8). Rows m >= cnt are zero. Thread tid writes row
// tid % P, chunks (tid / P) * kChunks onwards; word m + 3 holds the map
// columns 2j - 2 and 2j - 1.
template <int P>
__device__ __forceinline__ void build_rows(uint8_t* dst, const uint8_t* raw,
                                           int cnt, int tid) {
  using U = Unit<P>;
  constexpr int kQ = U::kChunks;
  const int m = tid % P, q0 = (tid / P) * kQ;
  // All the thread's words first: a store to shared memory would otherwise
  // hold back the next chunk's loads (the compiler cannot tell that they
  // do not alias).
  uint32_t wd[kQ][2][3];
#pragma unroll
  for (int e = 0; e < kQ; ++e) {
    const int q = q0 + e, row = (q >> 1) * 4 + (q & 1) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        wd[e][r][d] = *reinterpret_cast<const uint32_t*>(
            raw + U::offset(row + r, m + 3 + d));
  }
  const bool live = m < cnt;
#pragma unroll
  for (int e = 0; e < kQ; ++e) {
    const int q = q0 + e;
    // wd[e][r][d] holds map columns 2j - 2 + 2d, 2j - 1 + 2d: the low half
    // of each output pair is the high half of the word before it.
    uint4 v = make_uint4(__byte_perm(wd[e][0][0], wd[e][0][1], 0x5432),
                         __byte_perm(wd[e][0][1], wd[e][0][2], 0x5432),
                         __byte_perm(wd[e][1][0], wd[e][1][1], 0x5432),
                         __byte_perm(wd[e][1][1], wd[e][1][2], 0x5432));
    if (!live) v = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + m * kRowBytes + ((q ^ (m & 7)) << 4)) = v;
  }
}

// The producer's walk over `units` units (unit u: channel group u % 5 of
// segment sg0 + (u / 5) * stride), kDepth units of map rows staged ahead of
// the build, in kDepth + 2 raw slots: by TMA (kTma; slot s complete when
// mbarrier raw_full + 8 s flips) or by 4-byte cp.async (one commit group
// per unit). One named barrier (1, over the kProducers threads) per unit
// carries the rest of the producer's synchronisation, so that the ring's
// mbarriers see one warp or one thread, not eight warps: warp 0 waits until
// unit u's ring stage is free (wait_free), the barrier passes that on, and
// thread 0 then hands unit u - 1, which every thread built before the
// barrier, to the consumers (hand_over). A slot is refilled when it held
// unit u - 2, built before the barrier of unit u - 1. dst_of(u) is where
// unit u goes.
template <int P, int kDepth, bool kTma, class WaitFree, class DstOf,
          class HandOver>
__device__ __forceinline__ void produce(uint8_t* raw_base, uint32_t raw_full,
                                        int units,
                                        const __nv_bfloat16* __restrict__ x,
                                        const CUtensorMap* xmap, int c, int h,
                                        int w, int tid, int sg0, int stride,
                                        WaitFree wait_free, DstOf dst_of,
                                        HandOver hand_over) {
  constexpr int kSlots = kDepth + 2, kRaw = Unit<P>::kRawBytes;
  const uint32_t raw0 = smem_u32(raw_base);
  // the segments of the units staged and built
  SegWalk<P> staged(sg0, stride, h / 2, w / 2), built = staged;
  auto stage = [&](int v) {  // called by every producer thread, in order
    if (v > 0 && v % kKSteps == 0) staged.next();
    const uint32_t slot = raw0 + (v % kSlots) * kRaw;
    if (!kTma)
      stage_words<P>(slot, x, staged.get(), v % kKSteps, c, h, w, tid);
    else if (tid == 0)
      stage_tma<P>(slot, xmap, raw_full + 8 * (v % kSlots), staged.get(),
                   v % kKSteps);
  };
  for (int v = 0; v < kDepth; ++v) {
    if (v < units) stage(v);
    if (!kTma) cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    if (!kTma) {
      if (u + kDepth < units) stage(u + kDepth);
      cp_async_commit();
      cp_async_wait<kDepth>();
    } else {
      mbar_wait(raw_full + 8 * (u % kSlots), (u / kSlots) & 1);
    }
    if (u > 0 && u % kKSteps == 0) built.next();
    const Seg sg = built.get();
    if (tid < 32) wait_free(u, sg);
    bar_sync(1, kProducers);
    if (tid == 0 && u > 0) hand_over(u - 1);
    if (kTma && u + kDepth < units) stage(u + kDepth);
    // The consumers fence the async proxy after the full barrier, as the
    // core's do after its gather.
    build_rows<P>(dst_of(u), raw_base + (u % kSlots) * kRaw, sg.cnt, tid);
  }
  bar_sync(1, kProducers);
  if (tid == 0 && units > 0) hand_over(units - 1);
  if (!kTma) cp_async_wait<0>();
}

// ------------------------------------------------------------------ forward

constexpr int kFwdPx = 128;                    // pixels per tile
constexpr int kFwdStages = 6;                  // A ring
constexpr int kFwdDepth = 4;                   // units of map rows in flight
constexpr int kFwdATile = kFwdPx * kRowBytes;  // 16 KB
constexpr int kFwdRaw = Unit<kFwdPx>::kRawBytes;
constexpr size_t kFwdSmem = 1024 + kKSteps * kChunkBytes +
                            kFwdStages * kFwdATile + 2 * kChunkBytes +
                            (kFwdDepth + 2) * kFwdRaw +
                            (2 * kFwdStages + kFwdDepth + 3) * 8;

// out[n, i, j, :] = bias + sum over k of patch[(n, i, j), k] * wt[:, k].
// Tiles are row segments of 128 output pixels, walked persistently
// (blockIdx.x, + gridDim.x, ...). Warpgroups 0 and 1 produce, 2 and 3
// consume.
__global__ void __launch_bounds__(512, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tmap_w,
           const __grid_constant__ CUtensorMap tmap_x,
           const __nv_bfloat16* __restrict__ x,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
           int n, int c, int h, int w, int tma) {
  extern __shared__ uint8_t k4f_smem[];
  uint8_t* base = k4f_smem + ((1024 - (smem_u32(k4f_smem) & 1023)) & 1023);
  uint8_t* pW = base;
  uint8_t* pA = pW + kKSteps * kChunkBytes;
  uint8_t* pOut = pA + kFwdStages * kFwdATile;
  uint8_t* pRaw = pOut + 2 * kChunkBytes;
  const uint32_t sW = smem_u32(pW), sA = smem_u32(pA);
  const uint32_t full = smem_u32(pRaw + (kFwdDepth + 2) * kFwdRaw);
  const uint32_t empty = full + kFwdStages * 8;
  const uint32_t wbar = empty + kFwdStages * 8;
  const uint32_t raw_full = wbar + 8;  // kFwdDepth + 2 raw slots

  const int tid = threadIdx.x;
  const int ho = h / 2, wo = w / 2;
  const int tiles = n * ho * ((wo + kFwdPx - 1) / kFwdPx);
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's thread 0
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(wbar, 1);
    for (int s = 0; s < kFwdDepth + 2; ++s) mbar_init(raw_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProducers) {
    if (tid == 0) {  // the K-major (64, 16C) weights, once: K >= 16C zero
      mbar_expect_tx(wbar, kKSteps * kChunkBytes);
      for (int kt = 0; kt < kKSteps; ++kt)
        tma_load_3d(sW + kt * kChunkBytes, &tmap_w, wbar, kt * 64, 0, 0);
    }
    auto wait_free = [&](int u, const Seg&) {
      mbar_wait(empty + 8 * (u % kFwdStages), ((u / kFwdStages) & 1) ^ 1);
    };
    auto dst_of = [&](int u) { return pA + (u % kFwdStages) * kFwdATile; };
    auto hand_over = [&](int u) { mbar_arrive(full + 8 * (u % kFwdStages)); };
    if (tma)
      produce<kFwdPx, kFwdDepth, true>(pRaw, raw_full, my_tiles * kKSteps, x,
                                       &tmap_x, c, h, w, tid, blockIdx.x,
                                       gridDim.x, wait_free, dst_of,
                                       hand_over);
    else
      produce<kFwdPx, kFwdDepth, false>(pRaw, raw_full, my_tiles * kKSteps, x,
                                        &tmap_x, c, h, w, tid, blockIdx.x,
                                        gridDim.x, wait_free, dst_of,
                                        hand_over);
    return;
  }

  // ---- consumers: warpgroup cw computes pixels [64 cw, 64 cw + 64) of each
  // tile over all 64 channels.
  const int cw = (tid >> 7) - 2, ctid = tid & 127;
  const int warp = ctid >> 5, lane = tid & 31;
  float bias_r[16];  // this thread's columns 8 jj + 2 (lane % 4) + e
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    bias_r[2 * jj] = bias[8 * jj + 2 * (lane & 3)];
    bias_r[2 * jj + 1] = bias[8 * jj + 2 * (lane & 3) + 1];
  }
  uint8_t* stage_out = pOut + cw * kChunkBytes;
  mbar_wait(wbar, 0);
  SegWalk<kFwdPx> walk(blockIdx.x, gridDim.x, ho, wo);
  int u = 0;
  for (int t = 0; t < my_tiles; ++t, walk.next()) {
    const Seg sg = walk.get();
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    for (int g = 0; g < kKSteps; ++g, ++u) {
      const int s = u % kFwdStages;
      // one warp polls the mbarrier; the named barrier passes it on
      if (warp == 0) mbar_wait(full + 8 * s, (u / kFwdStages) & 1);
      bar_sync(2 + cw, 128);
      fence_proxy_async();
      wgmma_fence();
      const uint64_t da = desc_sw128(sA + s * kFwdATile + cw * kChunkBytes);
      const uint64_t db = desc_sw128(sW + g * kChunkBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 32 bytes along K per step
        wgmma_m64n64k16<0>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (g > 0) arrive_warp(empty + 8 * ((u - 1) % kFwdStages));
    }
    wgmma_wait<0>();
    arrive_warp(empty + 8 * ((u - 1) % kFwdStages));

    // Epilogue. acc[4 jj + 2 h + e] is row warp * 16 + lane / 4 + 8 h,
    // column 8 jj + 2 (lane % 4) + e of the warpgroup's 64 x 64 tile; it
    // goes to chunk jj ^ (row % 8) of the staged row, then each 128-byte
    // NHWC row leaves in eight coalesced 16-byte stores.
    bar_sync(2 + cw, 128);  // the last tile's stores have read the stage
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = warp * 16 + (lane >> 2) + 8 * h2;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(
            stage_out + r * kRowBytes + ((jj ^ (r & 7)) << 4) +
            4 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * h2] + bias_r[2 * jj],
                                  acc[4 * jj + 2 * h2 + 1] + bias_r[2 * jj + 1]);
    }
    bar_sync(2 + cw, 128);
    const size_t pix0 =
        (static_cast<size_t>(sg.n) * ho + sg.i) * wo + sg.j0 + cw * 64;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = ctid + 128 * k, r = idx >> 3, q = idx & 7;
      if (cw * 64 + r < sg.cnt)
        *reinterpret_cast<uint4*>(out + (pix0 + r) * kCout + q * 8) =
            *reinterpret_cast<const uint4*>(stage_out + r * kRowBytes +
                                            ((q ^ (r & 7)) << 4));
    }
  }
}

// -------------------------------------------------------------------- wgrad

constexpr int kWgPx = 64;                     // pixels per K step
constexpr int kWgStages = 3;                  // A (five chunks) + dy ring
constexpr int kWgDepth = 8;                   // units of map rows in flight
constexpr int kWgStage = (kKSteps + 1) * kChunkBytes;  // 48 KB
constexpr int kWgRaw = Unit<kWgPx>::kRawBytes;
constexpr size_t kWgradSmem = 1024 + kWgStages * kWgStage +
                              (kWgDepth + 2) * kWgRaw +
                              (2 * kWgStages + kWgDepth + 2) * 8;

// out[r][co] (r < 16c) = sum over the pixels of this split's K steps of
// patch[p, r] * dy[p, co]; out = ws + split * 16c * 64, or dk when there is
// one split. K step t is row segment t of 64 pixels (the last of a row
// masked: its patch rows are zero); split s takes steps [s * per, s * per +
// per). Stage layout: the five 64-row chunks of the patch (MN-major: pixel
// m's row at m * 128 bytes), then the dy box (64 pixels x 64 channels).
// Warpgroups 0 and 1 produce; warpgroup 2 accumulates chunks 0-2,
// warpgroup 3 chunks 3-4.
__global__ void __launch_bounds__(512, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap tmap_dy,
             const __grid_constant__ CUtensorMap tmap_x,
             const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
             int c, int h, int w, int steps, int per, int tma) {
  extern __shared__ uint8_t k4w_smem[];
  uint8_t* base = k4w_smem + ((1024 - (smem_u32(k4w_smem) & 1023)) & 1023);
  uint8_t* pRaw = base + kWgStages * kWgStage;
  const uint32_t sS = smem_u32(base);
  const uint32_t full = smem_u32(pRaw + (kWgDepth + 2) * kWgRaw);
  const uint32_t empty = full + kWgStages * 8;
  const uint32_t raw_full = empty + kWgStages * 8;  // kWgDepth + 2 raw slots

  const int tid = threadIdx.x;
  const int ho = h / 2, wo = w / 2;
  const int step0 = blockIdx.x * per;
  const int my_steps = min(steps, step0 + per) - step0;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 2);  // the producer's thread 0 + the TMA's
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < kWgDepth + 2; ++s) mbar_init(raw_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProducers) {
    auto wait_free = [&](int u, const Seg& sg) {
      const int j = u / kKSteps, s = j % kWgStages;
      if (u % kKSteps != 0) return;
      mbar_wait(empty + 8 * s, ((j / kWgStages) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(full + 8 * s, kChunkBytes);
        tma_load_3d(sS + s * kWgStage + kKSteps * kChunkBytes, &tmap_dy,
                    full + 8 * s, 0, (sg.n * ho + sg.i) * wo + sg.j0, 0);
      }
    };
    auto dst_of = [&](int u) {
      const int j = u / kKSteps;
      return base + (j % kWgStages) * kWgStage + (u - j * kKSteps) * kChunkBytes;
    };
    auto hand_over = [&](int u) {
      if (u % kKSteps == kKSteps - 1)
        mbar_arrive(full + 8 * ((u / kKSteps) % kWgStages));
    };
    if (tma)
      produce<kWgPx, kWgDepth, true>(pRaw, raw_full, my_steps * kKSteps, x,
                                     &tmap_x, c, h, w, tid, step0, 1,
                                     wait_free, dst_of, hand_over);
    else
      produce<kWgPx, kWgDepth, false>(pRaw, raw_full, my_steps * kKSteps, x,
                                      &tmap_x, c, h, w, tid, step0, 1,
                                      wait_free, dst_of, hand_over);
    return;
  }

  const int cw = (tid >> 7) - 2;
  float acc[3][32];
#pragma unroll
  for (int cc = 0; cc < 3; ++cc)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[cc][e] = 0.0f;
  for (int j = 0; j < my_steps; ++j) {
    const int s = j % kWgStages;
    if (((tid >> 5) & 3) == 0) mbar_wait(full + 8 * s, (j / kWgStages) & 1);
    bar_sync(2 + cw, 128);
    fence_proxy_async();
    wgmma_fence();
    const uint32_t st = sS + s * kWgStage;
    const uint64_t db = desc_mn_sw128(st + kKSteps * kChunkBytes, kChunkBytes);
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const int g = 3 * cw + cc;
      if (g < kKSteps) {
        const uint64_t da = desc_mn_sw128(st + g * kChunkBytes, kChunkBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 2,048 bytes (16 pixels) per step
          wgmma_m64n64k16<1>(acc[cc], da + 128 * kk, db + 128 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (j > 0) arrive_warp(empty + 8 * ((j - 1) % kWgStages));
  }
  wgmma_wait<0>();

  // acc[cc][4 jj + 2 h + e] is dW row 64 g + warp * 16 + lane / 4 + 8 h,
  // column 8 jj + 2 (lane % 4) + e.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int rows = 16 * c;
  float* dst = out + static_cast<size_t>(blockIdx.x) * rows * kCout;
#pragma unroll
  for (int cc = 0; cc < 3; ++cc) {
    const int g = 3 * cw + cc;
    if (g >= kKSteps) continue;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = 64 * g + warp * 16 + (lane >> 2) + 8 * h2;
      if (r >= rows) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * kCout +
                                   8 * jj + 2 * (lane & 3)) =
            make_float2(acc[cc][4 * jj + 2 * h2], acc[cc][4 * jj + 2 * h2 + 1]);
    }
  }
}

// -------------------------------------------------------------------- dgrad

constexpr int kDgQ = 64;                       // q-columns per tile
constexpr int kDgStages = 6;
constexpr int kDgBTile = 32 * kRowBytes;       // one class's K step, 32 rows
constexpr int kDgATile = 2 * kDgQ * kRowBytes; // both column parities: 16 KB
constexpr int kDgPitch = 2 * kDgQ + 4;         // f32 per staged channel row
constexpr size_t kDgradSmem = 1024 + 16 * kDgBTile + kDgStages * kDgATile +
                              32 * kDgPitch * 4 + (2 * kDgStages + 1) * 8;

// dx[n, :, y, 2 q0 .. 2 q0 + 127] for tile (n, y, q0): row parity py = y %
// 2, p = y / 2; warpgroup 1 + px computes column parity px (x = 2q + px):
// sum over taps t = 2a + b of dy[n, p + py - a, q + px - b, :] @ class
// (py, px)'s K step t. A rows 64 px + (q - q0) of each stage.
__global__ void __launch_bounds__(384, 1)
dgrad_kernel(const __grid_constant__ CUtensorMap tmap_w,
             const __nv_bfloat16* __restrict__ dy,
             __nv_bfloat16* __restrict__ dx, int n, int c, int h, int w) {
  extern __shared__ uint8_t k4d_smem[];
  uint8_t* base = k4d_smem + ((1024 - (smem_u32(k4d_smem) & 1023)) & 1023);
  const uint32_t sW = smem_u32(base);
  const uint32_t sA = sW + 16 * kDgBTile;
  float* sOut = reinterpret_cast<float*>(base + 16 * kDgBTile +
                                         kDgStages * kDgATile);
  const uint32_t full = smem_u32(sOut + 32 * kDgPitch);
  const uint32_t empty = full + kDgStages * 8;
  const uint32_t wbar = empty + kDgStages * 8;

  const int tid = threadIdx.x;
  const int ho = h / 2, wo = w / 2;
  const int per_row = (wo + kDgQ - 1) / kDgQ;
  const int tiles = n * h * per_row;

  if (tid == 0) {
    for (int s = 0; s < kDgStages; ++s) {
      mbar_init(full + 8 * s, 128);  // 128 cp.async arrivals
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    if (tid == 0) {  // all four classes' (32 rows x 256 K) matrices, once
      mbar_expect_tx(wbar, 16 * kDgBTile);
      for (int cls = 0; cls < 4; ++cls)
        for (int t = 0; t < 4; ++t)
          tma_load_3d(sW + (cls * 4 + t) * kDgBTile, &tmap_w, wbar, t * 64, 0,
                      cls);
    }
    // thread (chunk, r0) gathers 16 bytes of rows r0 + 16 i: rows 0-63
    // column parity 0, rows 64-127 parity 1.
    const int chunk = tid & 7, r0 = tid >> 3;
    const uint32_t a_dst = r0 * kRowBytes + ((chunk ^ (r0 & 7)) << 4);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row = tile / per_row;
      const int q0 = (tile - row * per_row) * kDgQ;
      const int nn = row / h, y = row - nn * h;
      const int p = y >> 1, py = y & 1;
      for (int t = 0; t < 4; ++t, ++it) {
        const int a = t >> 1, b = t & 1;
        const int s = it % kDgStages;
        mbar_wait(empty + 8 * s, ((it / kDgStages) & 1) ^ 1);
        const int sy = p + py - a;
        const bool row_ok = sy >= 0 && sy < ho;
        const uint32_t dst = sA + s * kDgATile + a_dst;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int sx = q0 + r0 + 16 * (i & 3) + (i >> 2) - b;
          const bool ok = row_ok && sx >= 0 && sx < wo;
          const __nv_bfloat16* src =
              ok ? dy + ((static_cast<size_t>(nn) * ho + sy) * wo + sx) *
                            kCout + chunk * 8
                 : dy;
          cp_async16(dst + i * 16 * kRowBytes, src, ok);
        }
        cp_async_arrive(full + 8 * s);
      }
    }
    cp_async_wait<0>();
    return;
  }

  const int px = (tid >> 7) - 1, ctid = tid - 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  mbar_wait(wbar, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row = tile / per_row;
    const int q0 = (tile - row * per_row) * kDgQ;
    const int nn = row / h, y = row - nn * h;
    const int cls = 2 * (y & 1) + px;
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
    for (int t = 0; t < 4; ++t, ++it) {
      const int s = it % kDgStages;
      mbar_wait(full + 8 * s, (it / kDgStages) & 1);
      fence_proxy_async();
      wgmma_fence();
      const uint64_t da = desc_sw128(sA + s * kDgATile + px * kDgQ * kRowBytes);
      const uint64_t db = desc_sw128(sW + (cls * 4 + t) * kDgBTile);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32k16(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (t > 0) arrive_warp(empty + 8 * ((it - 1) % kDgStages));
    }
    wgmma_wait<0>();
    arrive_warp(empty + 8 * ((it - 1) % kDgStages));

    // Planar epilogue: acc[4 jj + 2 h + e] is q-column q0 + warp * 16 +
    // lane / 4 + 8 h, channel 8 jj + 2 (lane % 4) + e; staged as f32
    // sOut[channel][x - 2 q0], then each channel's run of 128 dx columns
    // leaves in coalesced 4-byte stores (W is even, not a multiple of 8).
    bar_sync(2, 256);  // the last tile's stores have read sOut
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = 8 * jj + 2 * (lane & 3) + e;
          const int m = warp * 16 + (lane >> 2) + 8 * h2;
          if (ch < c) sOut[ch * kDgPitch + 2 * m + px] = acc[4 * jj + 2 * h2 + e];
        }
    bar_sync(2, 256);
    for (int idx = ctid; idx < c * kDgQ; idx += 256) {
      const int ch = idx / kDgQ, xp = idx - ch * kDgQ;
      if (q0 + xp < wo) {
        const float2 v =
            *reinterpret_cast<const float2*>(sOut + ch * kDgPitch + 2 * xp);
        *reinterpret_cast<__nv_bfloat162*>(
            dx + ((static_cast<size_t>(nn) * c + ch) * h + y) * w +
            2 * (q0 + xp)) = __floats2bfloat162_rn(v.x, v.y);
      }
    }
  }
}

// --------------------------------------------------------------- launching

// Set the kernel's dynamic shared memory once per process; returns a
// cudaError_t.
int configure(const void* kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  *done = err == cudaSuccess;
  return static_cast<int>(err);
}

// One persistent block per SM of the current device, at most `tiles`.
int persistent_grid(int tiles, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = tiles < sms ? tiles : sms;
  return static_cast<int>(err);
}

// The planar map's 4D tensor map (W, H, C, N) for the producer's TMA
// boxes of P: 16 map rows (4 channels x 4 rows) of Unit<P>::kBoxWords words,
// zero outside. Sets *tma to 0, and encodes nothing, where TMA cannot take
// the map: W % 8 != 0 (the row pitch must be a multiple of 16 bytes) or x
// not 16-byte aligned; the producer then stages by 4-byte cp.async.
template <int P>
int encode_planar_map(CUtensorMap* map, const void* x, int n, int c, int h,
                      int w, int* tma) {
  *tma = w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (!*tma) return 0;
  sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidDeviceFunction);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {2 * Unit<P>::kBoxWords, 4, 4, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

bool valid_shape(int n, int c, int h, int w) {
  return n > 0 && c > 0 && c <= 4 * kKSteps && h > 0 && w > 0 &&
         h % 2 == 0 && w % 2 == 0;
}

}  // namespace

// x: (n, c, h, w) bf16 planar, c <= 20, h and w even; wt: (64, 16c) bf16,
// the K-major weights, column c*16 + ky*4 + kx (OIHW reshaped); bias: (64,)
// f32; out: (n, h/2, w/2, 64) bf16.
extern "C" int asn_conv4x4_patch_fwd(const void* x, const void* wt,
                                     const void* bias, void* out, int n,
                                     int c, int h, int w, void* stream) {
  static bool done = false;
  if (!valid_shape(n, c, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  int err = configure(reinterpret_cast<const void*>(fwd_kernel), kFwdSmem,
                      &done);
  if (err) return err;
  CUtensorMap map, xmap;
  int tma = 0;
  err = encode_map_3d(&map, wt, 16 * c, kCout, 1, 64, kCout);
  if (!err) err = encode_planar_map<kFwdPx>(&xmap, x, n, c, h, w, &tma);
  if (err) return err;
  const int tiles = n * (h / 2) * ((w / 2 + kFwdPx - 1) / kFwdPx);
  int grid = 0;
  err = persistent_grid(tiles, &grid);
  if (err) return err;
  fwd_kernel<<<grid, 512, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      map, xmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), n, c,
      h, w, tma);
  return static_cast<int>(cudaGetLastError());
}

// dy: (n, h/2, w/2, 64) bf16; ws: (splits, 16c, 64) f32 scratch when splits
// > 1, else null; dk: (16c, 64) f32, row c*16 + ky*4 + kx. splits and per
// (64-pixel row segments per split) from the wrapper's wgrad_plan.
extern "C" int asn_conv4x4_patch_wgrad(const void* x, const void* dy,
                                       void* ws, void* dk, int n, int c,
                                       int h, int w, int splits, int per,
                                       void* stream) {
  static bool done = false;
  const int ho = h / 2, wo = w / 2;
  const int steps = n * ho * ((wo + kWgPx - 1) / kWgPx);
  if (!valid_shape(n, c, h, w) || splits < 1 || per < 1 ||
      static_cast<long long>(splits) * per < steps ||
      static_cast<long long>(splits - 1) * per >= steps ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = configure(reinterpret_cast<const void*>(wgrad_kernel), kWgradSmem,
                      &done);
  if (err) return err;
  // dy as (1, pixels, 64): boxes of 64 pixels x 64 channels, zero past the
  // last pixel.
  CUtensorMap map, xmap;
  int tma = 0;
  err = encode_map_3d(&map, dy, kCout, static_cast<uint64_t>(n) * ho * wo, 1,
                      64, kWgPx);
  if (!err) err = encode_planar_map<kWgPx>(&xmap, x, n, c, h, w, &tma);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_kernel<<<splits, 512, kWgradSmem, s>>>(
      map, xmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(splits > 1 ? ws : dk), c, h, w, steps, per, tma);
  err = static_cast<int>(cudaGetLastError());
  if (err || splits == 1) return err;
  return splitk::sum_splits(static_cast<const float*>(ws),
                            static_cast<float*>(dk), splits,
                            static_cast<long long>(16) * c * kCout, s);
}

// dy: (n, h/2, w/2, 64) bf16; wt: (4, c, 256) bf16, class z = 2*py + px,
// K-major row ci, column (2a + b)*64 + co holding W[co, ci, 1-py+2a,
// 1-px+2b] (conv4x4_s2.dgrad_weights); dx: (n, c, h, w) bf16.
extern "C" int asn_conv4x4_patch_dgrad(const void* dy, const void* wt,
                                       void* dx, int n, int c, int h, int w,
                                       void* stream) {
  static bool done = false;
  if (!valid_shape(n, c, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  int err = configure(reinterpret_cast<const void*>(dgrad_kernel), kDgradSmem,
                      &done);
  if (err) return err;
  CUtensorMap map;  // rows past c load as zero: N = c padded to 32
  err = encode_map_3d(&map, wt, 4 * kCout, c, 4, 64, 32);
  if (err) return err;
  const int tiles = n * h * ((w / 2 + kDgQ - 1) / kDgQ);
  int grid = 0;
  err = persistent_grid(tiles, &grid);
  if (err) return err;
  dgrad_kernel<<<grid, 384, kDgradSmem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), n, c, h, w);
  return static_cast<int>(cudaGetLastError());
}
