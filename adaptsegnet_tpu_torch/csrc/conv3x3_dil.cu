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
// the card both are one
// implicit GEMM (csrc/igemm_bf16.cuh): M = N*H*W pixels, N = Cout, K = 9*Cin,
// the shifted source pixel loaded per tap with zero padding on load, so no
// padded or shifted copy of the input ever reaches device memory.
//
// Bound on the H100: layer3 is 9.66 GFLOP against ~9.6 MB of traffic per
// call (~1,000 FLOP/byte), layer4 38.7 GFLOP: both are bound by the tensor
// cores (989 TFLOP/s bf16 dense), so the design keeps the products on them
// (wmma bf16 16x16x16, f32 accumulators) and hides the gathers behind a
// three-stage cp.async pipeline.
//
// dgrad is the same call with the spatially flipped, in/out-swapped weights
// (the wrapper builds them): for stride 1 and padding == dilation the
// transpose of the conv is that conv.

#include "igemm_bf16.cuh"

namespace {

// The geometry of the stride-1 dilated 3x3 over `groups` runs of `n` images.
igemm::Geo conv3x3_geo(int n, int groups, int h, int w, int cin, int cout,
                       int d) {
  igemm::Geo g;
  g.n = n;
  g.groups = groups;
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
  g.zpar = 0;
  return g;
}

}  // namespace

// x: (n, h, w, cin) bf16; wmat: (9 * cin, cout) bf16, row (ky*3 + kx)*cin + ci;
// out: (n, h, w, cout) bf16. cin % 32 == 0, cout % 8 == 0.
extern "C" int asn_conv3x3_dil(const void* x, const void* wmat, void* out,
                               int n, int h, int w, int cin, int cout, int d,
                               void* stream) {
  return igemm::launch(x, wmat, nullptr, out,
                       conv3x3_geo(n, 1, h, w, cin, cout, d),
                       static_cast<cudaStream_t>(stream));
}

// The batched forward of the eval path (kernel 3): the same conv on n >= 2
// images, nb images per group (n % nb == 0). blockIdx.z selects the group and
// a tile's 128 rows are pixels of that group only (M per group = nb * h * w,
// the last tile masked on load and on store when that is no multiple of 128,
// as on the Oracle's 65 x 129 maps), so consecutive blocks of a group share
// one weight tile through L2. Same operand layouts and constraints as above.
extern "C" int asn_conv3x3_dil_batched(const void* x, const void* wmat,
                                       void* out, int n, int nb, int h, int w,
                                       int cin, int cout, int d,
                                       void* stream) {
  if (nb < 1 || n % nb != 0) return static_cast<int>(cudaErrorInvalidValue);
  return igemm::launch(x, wmat, nullptr, out,
                       conv3x3_geo(nb, n / nb, h, w, cin, cout, d),
                       static_cast<cudaStream_t>(stream));
}
