#!/usr/bin/env python3
"""Time the Hopper core's two tiles on the 3x3 convs of kernels 2 and 3.

    python3 scripts/conv3x3_tile_sweep.py

For each main-path shape (kernel 2: layer3 and layer4 at one image, forward
and dgrad; kernel 3: layer2..4 at a batch of 4) launches
csrc/conv3x3_dil.cu with 128 x 128 and, where Cout is a multiple of 256,
with 128 x 256 tiles, whatever `tile_plan` would choose, checks each
result against the plain version (one bf16 ulp + 1e-3 of the largest
value), and prints one JSON line per
(shape, tile): the blocks of the grid, the device time per launch from a
torch.profiler window over 20 launches, the TFLOP/s it makes, whether the
plan picks that tile, and the card's nvidia-smi name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, N, H, W, C, d, dgrad)
SHAPES = (("k2 layer3 fwd", 1, 64, 128, 256, 2, False),
          ("k2 layer3 dgrad", 1, 64, 128, 256, 2, True),
          ("k2 layer4 fwd", 1, 64, 128, 512, 4, False),
          ("k2 layer4 dgrad", 1, 64, 128, 512, 4, True),
          ("k3 layer2 N4", 4, 64, 128, 128, 1, False),
          ("k3 layer3 N4", 4, 64, 128, 256, 2, False),
          ("k3 layer4 N4", 4, 64, 128, 512, 4, False))


def device_us(fn, iters: int = 20) -> float:
    """Mean device time of the core's kernel per fn() call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "conv_sm90_kernel" in e.key]
    if not events:
        raise RuntimeError("the profiler saw no conv_sm90_kernel")
    return sum(e.device_time_total for e in events) / sum(e.count for e in events)


def main() -> int:
    if not torch.cuda.is_available():
        print("conv3x3_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from adaptsegnet_tpu_torch.ops.kernels import _build
    from adaptsegnet_tpu_torch.ops.kernels import conv3x3_dil as k2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    lib = k2._library()
    rng = np.random.default_rng(0)
    for label, n, h, w, c, d, dgrad in SHAPES:
        x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        wgt = torch.from_numpy((rng.standard_normal((c, c, 3, 3)) * 0.02).astype(
            np.float32)).to("cuda", torch.bfloat16)
        wt = k2.kmajor_weights(wgt.transpose(0, 1) if dgrad else wgt).contiguous()
        ref = k2.conv3x3_dil_plain(x, k2.flip_weights(wgt) if dgrad else wgt, d).float()
        out = torch.empty_like(x)
        m = n * h * w
        for bn in (128, 256) if c % 256 == 0 else (128,):
            def launch(bn=bn):
                _build.raise_on(lib.asn_conv3x3_dil(
                    x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, w, c, c,
                    d, int(dgrad), bn, _build.stream(x)), label)

            launch()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
            if not bool((err <= tol).all()):
                raise RuntimeError(f"{label} bn {bn}: max abs error {err.max().item()}")
            us = device_us(launch)
            print(json.dumps({
                "shape": label, "tile": f"128x{bn}",
                "blocks": -(-m // 128) * (c // bn), "device_us": us,
                "tflops": 2 * m * 9 * c * c / us / 1e6,
                "planned": k2.tile_plan(m, c) == (128, bn), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
