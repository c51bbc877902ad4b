"""`python -m adaptsegnet_tpu_torch.cli.profile_step` — per-op step profile
on the CUDA card.

Counterpart of adaptsegnet_tpu/cli/profile_step.py, with its flags: traces
`--iters` steps of a train step (multi-level adversarial by default;
--source-only [--warper] for the CE pretraining modes) at 512x1024 with
torch.profiler and prints the per-op table (top ops by device self time,
the hand-written kernels under their CUDA names) and a rollup by op type,
then the kernel wrappers' launch counts over the traced steps.

Synthetic inputs, random init: the op mix and layouts are those of real
training, so per-op times transfer.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from adaptsegnet_tpu_torch.utils.profiling import op_stats, print_op_stats, trace


def get_arguments(argv=None):
    p = argparse.ArgumentParser(description="Per-op train-step profile")
    p.add_argument("--top", type=int, default=40,
                   help="rows of the per-op table")
    p.add_argument("--iters", type=int, default=6,
                   help="traced step executions")
    p.add_argument("--source-only", action="store_true",
                   help="profile the CE pretraining step instead")
    p.add_argument("--warper", action="store_true",
                   help="with --source-only: include the Warper path")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--trace-dir", default=None,
                   help="keep the raw trace here (default: temp dir)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_arguments(argv)

    from adaptsegnet_tpu_torch.device import resolve_device
    from adaptsegnet_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from adaptsegnet_tpu_torch.train.build import build_train_state
    from adaptsegnet_tpu_torch.train.config import TrainConfig
    from adaptsegnet_tpu_torch.train.steps import (
        make_adversarial_step,
        make_source_only_step,
    )

    device = resolve_device(None)
    hw = (512, 1024)
    size = f"{hw[1]},{hw[0]}"
    if args.source_only:
        cfg = TrainConfig(source_only=True, warper=args.warper,
                          compute_dtype=args.dtype, restore_from="",
                          input_size=size, batch_size=args.batch)
        step_fn = make_source_only_step(input_hw=hw)
    else:
        cfg = TrainConfig(source_only=False, level="multi-level",
                          warper=False, compute_dtype=args.dtype,
                          restore_from="", input_size=size,
                          input_size_target=size, batch_size=args.batch)
        step_fn = make_adversarial_step(level="multi-level", input_hw=hw)
    state = build_train_state(cfg, device)

    rng = np.random.default_rng(0)
    b = {
        "images": rng.standard_normal((1, args.batch, *hw, 3)).astype(np.float32),
        "labels": rng.integers(0, 19, size=(1, args.batch, *hw)),
    }
    if not args.source_only:
        b["target_images"] = rng.standard_normal(
            (1, args.batch, *hw, 3)).astype(np.float32)
    b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    m = step_fn(state, b)  # warm-up: builds and loads the kernels
    print("warm:", float(m["loss_seg2"]))

    tdir = args.trace_dir or tempfile.mkdtemp(prefix="torch_step_")
    reset_launch_counts()
    with trace(tdir):
        for _ in range(args.iters):
            last = step_fn(state, b)
        print("traced:", float(last["loss_seg2"]))
    counts = {k: v for k, v in launch_counts().items() if v}

    rows = op_stats(tdir, device_only=device.type == "cuda")
    print_op_stats(rows, top=args.top, iters=args.iters)
    print(f"\nkernel wrapper launches over the {args.iters} traced steps: "
          f"{json.dumps(counts)}")
    print("trace dir:", tdir)


if __name__ == "__main__":
    main()
