"""The readings that the limits of `correct` are set from, for one cell of
one card, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--out <file.jsonl>]

For each of --seeds, the program's numbers against the reference (the
lower readings: the largest over the seeds); for each of --control-seeds,
the control's (the reference in fp8, in the program's place: the upper
readings, the smallest over the seeds), and the faults the cell can have,
planted in the reference put in the program's place (training: 'half',
each step on half its batch, and in the multi-level step 'd1_split', D1's
weight gradient missing half of its sum) or in the program's answers (eval: one
pixel's class altered in each mask). Training needs no window; eval runs
each batch of the pool once. Prints one JSON line per seed and reading,
and a summary last.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def emit(out, record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    import torch

    from benchmark.lib import compare, harness, inputs, program, registry

    spec = registry.cell(args.workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    if spec["cell"]["chips"] != 1:
        p.error("calibrate.py reads cells of one card")
    device = device or torch.device("cuda", 0)
    rows = {"program": [], "control": [], "faults": []}
    if traffic["path"] == "train":
        for seed in seeds:
            state, step, batches, prog = harness.train_setup(spec, seed, device)
            del state, step, batches
            harness._free(device)
            ref = harness.reference_train(cfg, traffic, seed, device)
            nums = compare.train_numbers(prog, ref)
            del prog
            rows["program"].append(nums)
            emit(args.out, {"seed": seed, "reading": "program", **nums})
        faults = ["half"] + (["d1_split"] if cfg["mode"] == "multi-level" else [])
        for seed in control:
            ref = harness.reference_train(cfg, traffic, seed, device)
            for kind in ["control"] + faults:
                got = harness.reference_train(
                    cfg, traffic, seed, device, fp8=kind == "control",
                    fault=None if kind == "control" else kind)
                nums = compare.train_numbers(got, ref)
                rows["control" if kind == "control" else "faults"].append(
                    {"fault": kind, **nums})
                emit(args.out, {"seed": seed, "reading": kind, **nums})
    else:
        for seed in seeds + control:
            model, fn = program.build_eval(
                cfg, inputs.make_weights(cfg, seed, device), device)
            pool = inputs.make_pool(cfg, traffic, seed, device)
            kept = {i: tuple(t.cpu() for t in fn(b["images"], b["labels"]))
                    for i, b in enumerate(pool)}
            del model, fn
            harness._free(device)
            if seed in seeds:
                nums = harness.reference_eval(cfg, seed, pool, kept, device)
                rows["program"].append(nums)
                emit(args.out, {"seed": seed, "reading": "program", **nums})
            if seed in control:
                nums = harness.reference_eval(cfg, seed, pool, kept, device,
                                              fp8=True)
                rows["control"].append(nums)
                emit(args.out, {"seed": seed, "reading": "control", **nums})
                altered = {}
                for i, (masks, hist) in kept.items():
                    masks = masks.clone()
                    masks[:, 0, 0] = (masks[:, 0, 0] + 1) % cfg["num_classes"]
                    altered[i] = (masks, hist)
                nums = harness.reference_eval(cfg, seed, pool, altered, device)
                rows["faults"].append({"fault": "answer", **nums})
                emit(args.out, {"seed": seed, "reading": "answer", **nums})
            del pool
            harness._free(device)
    keys = rows["program"][0].keys()
    summary = {"lower": {k: max(r[k] for r in rows["program"]) for k in keys},
               "control_min": {k: min(r[k] for r in rows["control"])
                               for k in keys}}
    for f in {r["fault"] for r in rows["faults"]}:
        summary[f + "_min"] = {k: min(r[k] for r in rows["faults"]
                                      if r["fault"] == f) for k in keys}
    summary["seconds"] = time.time() - STARTED
    emit(args.out, {"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
