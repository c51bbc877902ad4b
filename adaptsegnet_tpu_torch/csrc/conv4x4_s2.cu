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
//   wgrad: dW[(ky, kx, ci), co] = sum over pixels of x(src) * dy, a GEMM
//          of (16*Cin) x Cout reduced over K = N*Ho*Wo pixels, on wgmma
//          (`wgrad_sm90_kernel` below, built from csrc/igemm_sm90.cuh's
//          ring, descriptors and transposed wgmma). Where the output tiles
//          cannot fill the card the pixels are split into `splits` ranges
//          (the wrapper's `wgrad_plan`), one f32 partial each, and
//          csrc/splitk.cuh sums the partials in split order: deterministic,
//          f32 out.
//
// Bound on the H100: at D conv2..4 and the encoder's down1..3 each
// direction is 8.59 GFLOP against a few MB of traffic, i.e. tensor-core
// bound (989 TFLOP/s bf16 dense: 8.69 us); at down4..out (output 16x32 ..
// 2x4, K = 8,192) the 8.4 MB weight read bounds the call (2.5-4.3 us),
// which is why the forward splits K there: 4-16 output tiles become >= 132
// blocks that each read a slice of the weights once.
//
// The wgrad's operands are both MN-major: for one pixel (its K index) the
// Cin channels of x at a tap, and the Cout channels of dy, lie contiguous.
// So neither is transposed on the way in: a 128-row tile of dW rows (one
// tap where Cin >= 128, two at Cin = 64) takes, per pixel, one 128-byte row
// of x per 64 rows, gathered by 16-byte cp.async (zero fill outside the
// image and past the last pixel), and dy comes by two TMA boxes of 64
// pixels x 64 channels per stage; both land in the 128B-swizzled MN-major
// layout (pixel k's row at k * 128 bytes, its 16-byte chunk c at c ^ (k %
// 8)), and wgmma reads them with the transpose flags set. Splitting K over
// the pixels only as far as one wave of blocks needs keeps the f32
// partials, written and read again by the second pass, at <= 8.4 MB at the
// D convs and at none at conv4, whose 128 tiles fill the card.

#include "igemm_sm90.cuh"
#include "splitk.cuh"

namespace {

constexpr int kWgBM = 128, kWgBN = 128;  // dW rows x output channels
using WgRing = sm90::Ring<2, kWgBN>;     // two consumer warpgroups
constexpr int kWgHalf = 64 * sm90::kRowBytes;  // 64 K rows of 128 bytes

struct WgradGeo {
  int h, w, cin, cout;  // x: (n, h, w, cin), dy: (n, ho, wo, cout)
  int ho, wo, m;        // output grid, pixels in all (K of the GEMM)
  int per;              // pixels per split (blockIdx.z), a multiple of 64
};

// out[split][r][co] = sum over this split's pixels p of
//   x[n, 2i + ky - 1, 2j + kx - 1, ci] * dy[p, co], r = (ky*4 + kx)*cin + ci,
// p = (n, i, j). Stage s holds A as two 64-row halves (rows r0 .. r0 + 63,
// r0 + 64 .. r0 + 127 of dW) and B as two 64-column halves, each half 64
// pixels x 128 bytes in the MN-major swizzled layout. out is dk itself when
// splits == 1.
__global__ void __launch_bounds__(384, 1)
wgrad_sm90_kernel(const __grid_constant__ CUtensorMap tmap_dy,
                  const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                  const WgradGeo g) {
  using namespace sm90;
  constexpr int kStages = WgRing::kStages;
  constexpr int kATile = WgRing::kATileBytes, kBTile = WgRing::kBTileBytes;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t sA = (raw + 1023) & ~1023u;
  const uint32_t sB = sA + kStages * kATile;
  const uint32_t full = sB + kStages * kBTile;
  const uint32_t empty = full + kStages * 8;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  const int split = blockIdx.z;
  const int p0 = split * g.per;
  const int kt_count = (min(g.m, p0 + g.per) - p0 + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128 + 1);  // 128 cp.async arrivals + the TMA's
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: thread (chunk, k0) gathers 16 bytes of pixels k0 + 16 i
    // of each stage, for both 64-row halves of the tile.
    const int chunk = tid & 7, k0 = tid >> 3;
    int offy[2], offx[2], coff[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = r0 + 64 * b;
      const int tap = r / g.cin;
      offy[b] = (tap >> 2) - 1;
      offx[b] = (tap & 3) - 1;
      coff[b] = r - tap * g.cin + chunk * 8;
    }
    // Pixel p = p0 + 64 kt + k0 + 16 i as (image, row, column), stepped by
    // 64 pixels per stage.
    int pm[4], pn[4], pi[4], pj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pm[i] = p0 + k0 + 16 * i;
      pj[i] = pm[i] % g.wo;
      const int t = pm[i] / g.wo;
      pi[i] = t % g.ho;
      pn[i] = t / g.ho;
    }
    // 128B swizzle: the 16-byte chunk c of K row k sits at chunk c ^ (k % 8).
    const uint32_t a_dst = k0 * kRowBytes + ((chunk ^ (k0 & 7)) << 4);
    for (int it = 0; it < kt_count; ++it) {
      const int s = it % kStages;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      if (tid == 0) {
        const uint32_t b_dst = sB + s * kBTile;
        mbar_expect_tx(full + 8 * s, kBTile);
        tma_load_3d(b_dst, &tmap_dy, full + 8 * s, n0, p0 + it * kBK, 0);
        tma_load_3d(b_dst + kWgHalf, &tmap_dy, full + 8 * s, n0 + 64,
                    p0 + it * kBK, 0);
      }
      const uint32_t dst = sA + s * kATile + a_dst;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int y = 2 * pi[i] + offy[b], xx = 2 * pj[i] + offx[b];
          const bool ok = pm[i] < g.m && y >= 0 && y < g.h && xx >= 0 &&
                          xx < g.w;
          const __nv_bfloat16* p =
              ok ? x + (static_cast<size_t>(pn[i] * g.h + y) * g.w + xx) *
                           g.cin + coff[b]
                 : x;
          cp_async16(dst + b * kWgHalf + i * 16 * kRowBytes, p, ok);
        }
        pm[i] += kBK;
        pj[i] += kBK;
        while (pj[i] >= g.wo) {
          pj[i] -= g.wo;
          if (++pi[i] == g.ho) {
            pi[i] = 0;
            ++pn[i];
          }
        }
      }
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: warpgroup cw computes dW rows r0 + [cw * 64, cw * 64 + 64)
  // over all 128 columns. Each k16 step is 16 K rows = two 1,024-byte atoms.
  const int cw = (tid >> 7) - 1;
  float acc[kWgBN / 2];
#pragma unroll
  for (int e = 0; e < kWgBN / 2; ++e) acc[e] = 0.0f;
  for (int it = 0; it < kt_count; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgmma_fence();
    const uint64_t da = desc_mn_sw128(sA + s * kATile + cw * kWgHalf, kWgHalf);
    const uint64_t db = desc_mn_sw128(sB + s * kBTile, kWgHalf);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 2,048 bytes along K per step
      wgmma_m64n128k16<1>(acc, da + 128 * kk, db + 128 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();

  // acc[4 j + 2 h + e] is row warp * 16 + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 tile.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  float* dst = out + static_cast<size_t>(split) * 16 * g.cin * g.cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int jj = 0; jj < kWgBN / 8; ++jj) {
      const int col = n0 + 8 * jj + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * g.cout + col) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
  }
}

}  // namespace

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

// x: (n, h, w, cin) bf16; dy: (n, h/2, w/2, cout) bf16; dk: (16*cin, cout)
// f32, row (ky*4 + kx)*cin + ci; splits and per (pixels per split, a
// multiple of 64) from the wrapper's plan; ws: (splits, 16*cin, cout) f32
// scratch when splits > 1, else null (the kernel writes dk). cin % 64 == 0,
// cout % 128 == 0.
extern "C" int asn_conv4x4_s2_wgrad(const void* x, const void* dy, void* ws,
                                    void* dk, int n, int h, int w, int cin,
                                    int cout, int splits, int per,
                                    void* stream) {
  WgradGeo g;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.ho = h / 2;
  g.wo = w / 2;
  g.m = n * g.ho * g.wo;
  g.per = per;
  if (cin % 64 || cout % kWgBN || splits < 1 || per < 1 || per % sm90::kBK ||
      static_cast<long long>(splits) * per < g.m ||
      static_cast<long long>(splits - 1) * per >= g.m ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = WgRing::kSmemBytes;
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wgrad_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // dy as (1, m, cout): boxes of 64 pixels x 64 channels, zero past m.
  CUtensorMap map;
  int err = sm90::encode_map_3d(&map, dy, cout, g.m, 1, 64, sm90::kBK);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(16 * cin / kWgBM, cout / kWgBN, splits);
  wgrad_sm90_kernel<<<grid, 384, bytes, s>>>(
      map, static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(splits > 1 ? ws : dk), g);
  err = static_cast<int>(cudaGetLastError());
  if (err || splits == 1) return err;
  return splitk::sum_splits(static_cast<const float*>(ws),
                            static_cast<float*>(dk), splits,
                            static_cast<long long>(16) * cin * cout, s);
}
