#!/usr/bin/env python3
"""Time the port's batched bf16 eval on one CUDA card, for A/B runs.

    python3 scripts/eval_batch_time.py [--root DIR] [--tag NAME]

Builds the two segmenters whose batched bf16 eval runs kernel 3 (random
weights, seed 0) with the code of the checkout at --root (default: the one
this script lies in; an unpacked copy of another commit times that commit's
code, which builds its own kernels): DeeplabMulti on one batch of 4 and the
Oracle (DeeplabSingle, 65x129 logit maps) on one batch of 2, as
`chip_smoke.py` phases 4 and 13 drive them. Each runs
`make_eval_fn(model, dtype=torch.bfloat16)` on preprocessed noise images at
512x1024 -> 1024x2048 masks, input on the card, where kernel 3 takes the
30 layer2..layer4 3x3 convs. Prints one JSON line per model: ms per batch
by CUDA events over 10 rounds after 3 warm-up rounds, kernel launches per
batch by wrapper, and from a torch.profiler window of 3 rounds the
device-busy ms per batch, the device ms of the implicit-GEMM conv kernels
(`conv_sm90_kernel`: kernel 3 on this path), with
the card's nvidia-smi name, power limit and SM clock, read right after
that window.
Put two checkouts' runs in one call, in turns (A, B, B, A), to compare
them on one card (`scripts/ab_turns.sh`).
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
ROUNDS = 10
MODELS = (("DeeplabMulti", 4), ("DeeplabSingle", 2))


def time_model(name: str, batch: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adaptsegnet_tpu_torch import models
    from adaptsegnet_tpu_torch.data.preprocessing import preprocess_image
    from adaptsegnet_tpu_torch.eval.evaluator import make_eval_fn
    from adaptsegnet_tpu_torch.ops import kernels

    hw = (512, 1024)
    cls = getattr(models, name)
    cpu = cls(device="cpu", generator=torch.Generator().manual_seed(0))
    model = cls(dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(cpu.state_dict())
    model.eval()
    del cpu
    rng = np.random.default_rng(0)
    images = torch.from_numpy(np.stack([
        preprocess_image(rng.integers(0, 256, hw + (3,)).astype(np.float32))
        for _ in range(batch)])).cuda()
    eval_fn = make_eval_fn(model, out_hw=(1024, 2048), dtype=torch.bfloat16)
    for _ in range(3):
        eval_fn(images)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ROUNDS):
        eval_fn(images)
    end.record()
    torch.cuda.synchronize()
    launches = {k: v / ROUNDS for k, v in kernels.launch_counts().items() if v}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eval_fn(images)
        torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    card, sm = smi.rsplit(", ", 1)
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in device) / 3e3
    igemm = sum(e.device_time_total for e in device
                if "conv_sm90_kernel" in e.key) / 3e3
    del model, eval_fn
    torch.cuda.empty_cache()
    return {"model": name, "batch": batch,
            "ms_per_batch": start.elapsed_time(end) / ROUNDS,
            "device_busy_ms_per_batch": busy,
            "igemm_device_ms_per_batch": igemm,
            "launches_per_batch": launches, "sm_clock": sm, "card": card}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eval_batch_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    for name, batch in MODELS:
        print(json.dumps({"tag": args.tag or args.root,
                          **time_model(name, batch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
