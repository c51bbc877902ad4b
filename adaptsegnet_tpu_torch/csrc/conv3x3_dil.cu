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
// the card both are one implicit GEMM on the Hopper core
// (csrc/igemm_sm90.cuh: wgmma from 128B-swizzled shared memory, the K-major
// weights by TMA, the gather by cp.async, a 5-stage mbarrier ring): M =
// N*H*W pixels (the batch flattened into M, so a tile may straddle two
// images and only the last tile is masked), N = Cout, K = 9*Cin, the shifted
// source pixel loaded per tap with zero padding on load, so no padded or
// shifted copy of the input ever reaches device memory.
//
// Bound on the H100: layer3 is 9.66 GFLOP per image against ~9.6 MB of
// traffic (~1,000 FLOP/byte), layer4 38.7 GFLOP: both are bound by the
// tensor cores (989 TFLOP/s bf16 dense). The wider 128 x 256 tile halves
// the gather's L2 traffic per product, but at one image (M = 8,192, the
// train path) it would leave layer3 with 64 blocks for 132 SMs; the caller's
// tile plan (ops/kernels/conv3x3_dil.py::tile_plan) takes it only where the
// grid still holds about one full wave.
//
// dgrad is the same conv with in/out channels swapped and the kernel
// flipped in space: for stride 1 and padding == dilation the transpose of
// the conv is that conv. The flip is taken in the gather (`flip`: tap
// (ky, kx) reads the source at ((1 - ky) d, (1 - kx) d) instead of
// ((ky - 1) d, (kx - 1) d)), so the dgrad's weights are the K-major matrix
// of the io-swapped kernel, one relayout of w.

#include "igemm_sm90.cuh"

// x: (n, h, w, cin) bf16; wt: (cout, 9 * cin) bf16, K-major, column
// (ky*3 + kx)*cin + ci; out: (n, h, w, cout) bf16; flip: 0 forward, 1 the
// taps mirrored (the dgrad); bn: 128 or 256 columns per tile (rows: 128).
// cin % 64 == 0, cout % 8 == 0.
extern "C" int asn_conv3x3_dil(const void* x, const void* wt, void* out,
                               int n, int h, int w, int cin, int cout, int d,
                               int flip, int bn, void* stream) {
  sm90::Geo g;
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
  g.tmul = flip ? -d : d;
  g.tadd = flip ? d : -d;
  g.os = 1;
  g.oh_out = h;
  g.ow_out = w;
  g.ncols = cout;
  g.zpar = 0;
  g.splits = 1;
  g.per = 9 * cin / sm90::kBK;
  return sm90::launch(x, wt, nullptr, out, nullptr, g, 128, bn,
                      static_cast<cudaStream_t>(stream));
}
