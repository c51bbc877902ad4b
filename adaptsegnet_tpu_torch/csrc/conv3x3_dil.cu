// Dilated 3x3 stride-1 convolution (padding = dilation), NHWC bf16, f32
// accumulation, bf16 out: the backbone's layer3 (d=2, C=256) and layer4 (d=4,
// C=512) 3x3 convs on the train path, forward and dgrad (kernel 2), and the
// batched forward of the bf16 eval path, which also takes layer2 (d=1,
// C=128) (kernel 3).
//
// Replaces the TPU kernels of adaptsegnet_tpu/ops/pallas/conv3x3_dil.py:
// `conv3x3_dil_mxu` (Pallas `_kernel`), nine (R*W, C) @ (C, C) tap matmuls
// per R-row VMEM block with the shifts sliced in VMEM, and
// `conv3x3_dil_mxu_batched` (`_kernel_batched`), the same with NB images per
// block. Its row slabs, halo rows and VMEM budget are not carried over. On
// the card both are one implicit GEMM: M = N*H*W pixels, N = Cout,
// K = 9*Cin, the shifted source pixel loaded per tap with zero padding on
// load, so no padded or shifted copy of the input ever reaches device
// memory.
//
// Bound on the H100: layer3 is 9.66 GFLOP per image against ~9.6 MB of
// traffic (~1,000 FLOP/byte), layer4 38.7 GFLOP: both are bound by the
// tensor cores (989 TFLOP/s bf16 dense).
// - Kernel 3 (the batched eval forward) runs on the Hopper core,
//   csrc/igemm_sm90.cuh: wgmma from 128B-swizzled shared memory, the
//   K-major weights by TMA, the gather by cp.async, a 5-stage mbarrier
//   ring. The batch is flattened into M, so a 128-row tile may straddle two
//   images and only the batch's last tile is masked.
// - Kernel 2 (forward and dgrad on the train path) stays on the wmma core,
//   csrc/igemm_bf16.cuh (16x16x16 fragments, three cp.async stages); its
//   move to the Hopper core is queued.
//
// dgrad is the same call with the spatially flipped, in/out-swapped weights
// (the wrapper builds them): for stride 1 and padding == dilation the
// transpose of the conv is that conv.

#include "igemm_bf16.cuh"
#include "igemm_sm90.cuh"

namespace {

// The geometry of the stride-1 dilated 3x3 over n images, for either core.
template <typename G>
G conv3x3_geo(int n, int h, int w, int cin, int cout, int d) {
  G g;
  g.n = n;
  g.oh = h;
  g.ow = w;
  g.sh = h;
  g.sw = w;
  g.cs = cin;
  g.kw = 3;
  g.taps = 9;
  g.rs = 1;
  g.ry = 0;
  g.rx = 0;
  g.tmul = d;
  g.tadd = -d;
  g.os = 1;
  g.oh_out = h;
  g.ow_out = w;
  g.ncols = cout;
  return g;
}

}  // namespace

// x: (n, h, w, cin) bf16; wmat: (9 * cin, cout) bf16, row (ky*3 + kx)*cin + ci;
// out: (n, h, w, cout) bf16. cin % 32 == 0, cout % 8 == 0.
extern "C" int asn_conv3x3_dil(const void* x, const void* wmat, void* out,
                               int n, int h, int w, int cin, int cout, int d,
                               void* stream) {
  return igemm::launch(x, wmat, out,
                       conv3x3_geo<igemm::Geo>(n, h, w, cin, cout, d),
                       static_cast<cudaStream_t>(stream));
}

// The batched forward of the eval path (kernel 3): the same conv on n >= 2
// images, the batch flattened into M. x: (n, h, w, cin) bf16; wt: (cout,
// 9 * cin) bf16, K-major, column (ky*3 + kx)*cin + ci; out: (n, h, w, cout)
// bf16. cin % 64 == 0, cout % 8 == 0.
extern "C" int asn_conv3x3_dil_batched(const void* x, const void* wt,
                                       void* out, int n, int h, int w,
                                       int cin, int cout, int d,
                                       void* stream) {
  sm90::Geo g = conv3x3_geo<sm90::Geo>(n, h, w, cin, cout, d);
  g.zpar = 0;
  g.splits = 1;
  g.per = 9 * cin / sm90::kBK;
  // 128 x 256 tiles where Cout allows (layer3, layer4): each gathered A
  // tile then feeds twice the columns, halving the gather's L2 traffic.
  return sm90::launch(x, wt, nullptr, out, nullptr, g, 128,
                      cout % 256 == 0 ? 256 : 128,
                      static_cast<cudaStream_t>(stream));
}
