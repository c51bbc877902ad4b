#!/usr/bin/env python3
"""Time kernel 1 (upsample + argmax) at the eval shape over channel counts.

    python3 scripts/argmax_channel_sweep.py [--root DIR] [--tag NAME]

Imports the port from the checkout at --root (default: this one), so two
checkouts can be compared in turns on one card. For each channel count C in
CHANNELS and each dtype (bf16, f32) it launches
csrc/upsample_argmax.cu on (1, 64, 128, C) N(0, 1) logits -> 1024x2048,
checks that the masks equal the plain version's on every pixel whose top-2
margin is not a near-tie (<= 1e-5 of the largest logit), and prints one JSON
line: the device time per launch (the least of three torch.profiler windows
over 20 launches each), the chunk width the checkout picks where it has
`chunk_width`, and the card's nvidia-smi name and power limit. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (8, 12, 16, 18, 19, 20, 24, 32, 38, 45, 64, 100)
OUT_HW = (1024, 2048)


def device_us(fn, iters: int = 20) -> float:
    """Mean device time of the kernel per fn() call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and "upsample_argmax_kernel" in e.key]
    if not events:
        raise RuntimeError("the profiler saw no upsample_argmax_kernel")
    return sum(e.device_time_total for e in events) / sum(e.count for e in events)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("argmax_channel_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    k1 = importlib.import_module("adaptsegnet_tpu_torch.ops.kernels.upsample_argmax")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    width = getattr(k1, "chunk_width", None)
    rng = np.random.default_rng(0)
    for c in CHANNELS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(rng.standard_normal((1, 64, 128, c)).astype(
                np.float32)).to("cuda", dtype)
            mask = k1.upsample_argmax(x, OUT_HW)
            up = k1.resize_bilinear_align_corners(x.float(), OUT_HW, exact=True)
            top2 = up.topk(2, -1).values
            clear = top2[..., 0] - top2[..., 1] > 1e-5 * up.abs().max()
            agree = bool((mask.long() == up.argmax(-1))[clear].all())
            if not agree:
                print(f"argmax_channel_sweep: C {c} {dtype} disagrees with plain",
                      file=sys.stderr)
                return 1
            us = min(device_us(lambda: k1.upsample_argmax(x, OUT_HW))
                     for _ in range(3))
            print(json.dumps({
                "tag": args.tag or args.root, "C": c, "dtype": str(dtype),
                "chunk_width": width(c) if width else None,
                "device_us": round(us, 2), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
