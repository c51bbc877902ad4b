#!/usr/bin/env python3
"""Time the port's bf16 train step on one CUDA card, for A/B runs.

    python3 scripts/train_step_time.py [--mode multi-level|source-only|single-level]
                                       [--steps 10] [--warmup 2] [--root DIR]
                                       [--tag NAME]

Builds the train state with the code of the checkout at --root (default:
the one this script lies in; an unpacked copy of another commit times that
commit's code, which builds its own kernels), runs `--warmup` steps, then
`--steps` steps between two CUDA events at 512x1024, bs 1, seed 0, with
synthetic batches, and prints one JSON line: ms/step, kernel launches per
step by wrapper (where the checkout counts them), peak memory, the
device-busy ms per step from a torch.profiler window over 3 more steps,
and the card's nvidia-smi name, power limit and SM clock, read right
after that window. Source-only and single-level build the
8-layer Warper where the checkout has one. Put two checkouts' runs in one
call, in turns (A, B, B, A), to compare them on one card
(`scripts/ab_turns.sh`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="multi-level",
                    choices=("multi-level", "source-only", "single-level"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from adaptsegnet_tpu_torch.data.preprocessing import preprocess_image
    from adaptsegnet_tpu_torch.ops import kernels
    from adaptsegnet_tpu_torch.train.build import build_train_state
    from adaptsegnet_tpu_torch.train.config import TrainConfig
    from adaptsegnet_tpu_torch.train.steps import (
        make_adversarial_step,
        make_source_only_step,
    )

    hw = (512, 1024)
    cfg = TrainConfig(source_only=args.mode == "source-only",
                      level="single-level" if args.mode == "single-level"
                      else "multi-level",
                      warper=args.mode != "multi-level",
                      compute_dtype="bfloat16", restore_from="", random_seed=0)
    state = build_train_state(cfg, torch.device("cuda"))
    step = (make_source_only_step(input_hw=hw) if cfg.source_only
            else make_adversarial_step(level=cfg.level, input_hw=hw))
    rng = np.random.default_rng(0)

    def image():
        return preprocess_image(rng.integers(0, 256, hw + (3,)).astype(np.float32))

    batches = []
    for _ in range(3):
        labels = rng.integers(0, 19, (1, 1) + hw)
        batches.append({
            "images": torch.from_numpy(image()[None, None]).cuda(),
            "target_images": torch.from_numpy(image()[None, None]).cuda(),
            "labels": torch.from_numpy(labels).cuda(),
        })
    for i in range(args.warmup):
        step(state, batches[i % 3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(args.steps):
        step(state, batches[i % 3])
    end.record()
    torch.cuda.synchronize()
    ms_per_step = start.elapsed_time(end) / args.steps
    launches = {k: v / args.steps for k, v in kernels.launch_counts().items() if v}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step(state, batches[i % 3])
        torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    smi, sm = smi.rsplit(", ", 1)
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 3e3
    print(json.dumps({
        "tag": args.tag or args.root, "mode": args.mode,
        "ms_per_step": ms_per_step, "launches_per_step": launches,
        "peak_gib": peak_gib, "device_busy_ms_per_step": busy,
        "sm_clock": sm, "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
