"""The benchmark of adaptsegnet_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. It
makes its weights and inputs on the card from --seed, sets up the cell
(BENCHMARK.json's `workloads`, with its configuration, traffic, work table
and limits, each found by name under benchmark/), runs the timed path for
--seconds, checks what it produced against the plain reference
(benchmark/reference), and prints one JSON line last on standard output:
the end-to-end metrics with --trace 0, the per-layer metrics with
--trace 1, whether the outputs are correct, and the numbers compared,
each beside its limit (also the last lines on standard error). It exits
nonzero, with no result, without the cards the cell asks for, when a
traced window cannot be read whole, or when JAX or the JAX package has
been loaded.
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
# The program's kernels build into its own _build/ in the checkout; any
# other kernel cache stays in the checkout too, at a fixed path.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, "_bench_cache", sub))

FORBIDDEN = {"jax", "jaxlib", "flax", "adaptsegnet_tpu"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def rank_train(spec, seed, seconds, tracing, started, cpu=False, wrap=None):
    """One rank of a cell of several cards (run by parallel/group.py's
    launch, one process per card; gloo ranks on the CPU in the tests)."""
    import torch

    from adaptsegnet_tpu_torch.parallel import group
    from benchmark.lib import harness

    device = (torch.device("cpu") if cpu else
              torch.device("cuda", torch.cuda.current_device()))
    return harness.program_train(spec, seed, seconds, tracing, device,
                                 started, wrap_step=wrap, group=group)


def program_side(spec, args, device, wrap=None) -> tuple[list, object]:
    """Each rank's readings of the program (and the eval pool)."""
    import torch

    from benchmark.lib import harness

    path, cards = spec["traffic"]["path"], spec["cell"]["chips"]
    if path == "eval":
        out, pool = harness.program_eval(spec, args.seed, args.seconds,
                                         bool(args.trace), device, STARTED,
                                         wrap_eval=wrap)
        return [out], pool
    if cards == 1:
        return [harness.program_train(spec, args.seed, args.seconds,
                                      bool(args.trace), device, STARTED,
                                      wrap_step=wrap)], None
    from adaptsegnet_tpu_torch.parallel import group
    cpu = torch.device(device).type == "cpu"
    return group.launch(rank_train, cards, cpu=cpu,
                        args=(spec, args.seed, args.seconds, bool(args.trace),
                              STARTED, cpu, wrap), timeout=300), None


def reference_side(spec, args, ranks, pool, device) -> dict:
    from benchmark.lib import compare, harness

    cfg, traffic = spec["cfg"], spec["traffic"]
    if traffic["path"] == "eval":
        return harness.reference_eval(cfg, args.seed, pool, ranks[0]["kept"],
                                      device)
    ref = harness.reference_train(cfg, traffic, args.seed, device)
    return compare.train_numbers(ranks[0]["readings"], ref)


def readings(spec, ranks) -> dict:
    lead = ranks[0]
    out = {"window": lead["window"], "plan": spec["plan"],
           "chips": spec["cell"]["chips"], "traffic": spec["traffic"]}
    if "trace" in lead:
        tr = dict(lead["trace"])
        tr["busy_s_mean"] = sum(r["trace"]["busy_s"] for r in ranks) / len(ranks)
        out["trace"] = tr
    return out


def main(argv=None, device=None, wrap=None) -> int:
    """`device` (a CPU device in the benchmark's tests) skips the look for
    cards; `wrap` substitutes the timed path (a test's planted fault)."""
    args = parse(argv)
    import torch

    from benchmark.lib import compare, registry
    from benchmark.lib.harness import HarnessError

    spec = registry.cell(args.workload)
    cards = spec["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
            print(f"{args.workload} needs {cards} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  " visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        if cards == 1:
            torch.cuda.set_device(device)
    try:
        ranks, pool = program_side(spec, args, device, wrap)
    except HarnessError as e:
        print(f"window not readable: {e}", file=sys.stderr)
        return 3
    lead = ranks[0]
    t_ref = time.time()
    numbers = reference_side(spec, args, ranks, pool, device)
    print(f"reference: {time.time() - t_ref:.1f} s", file=sys.stderr)
    limits = spec["limits"]
    correct = compare.verdict(numbers, limits) and lead["failed"] == 0
    run = readings(spec, ranks)
    metrics = {}
    if args.trace:
        for m in spec["per_layer"]:
            value = registry.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        w = lead["window"]
        rate = w["images"] / ((w["t1"] - w["t0"]) / 1e9)
        for m in spec["end_to_end"]:
            value = lead["setup_s"] if m["name"] == "setup_s" else rate
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cards,
           "memory_peak_bytes": max(r["peak"] for r in ranks)}
    result = {"correct": correct, "attempted": lead["window"]["calls"],
              "failed": lead["failed"], "metrics": metrics, "device": dev}
    if "trace" in run:
        dev["busy_s"] = run["trace"]["busy_s_mean"]
        dev["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                               "idle_gaps": run["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": numbers.get(k), "limit": v}
                        for k, v in limits.items()}
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"modules that the benchmark may not load: {loaded}",
              file=sys.stderr)
        return 4
    for k, v in limits.items():
        print(f"check {k} {numbers.get(k)!r} limit {v!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
