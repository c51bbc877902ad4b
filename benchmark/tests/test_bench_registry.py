"""A configuration, a traffic mix, a work table, a metric and a cell are
found by name from files of their own: added to a temporary copy, with no
file of the harness edited, they run."""

from __future__ import annotations

import json
import os

from benchmark.tests.conftest import run_tiny


def test_added_files_make_a_runnable_cell(tiny_root):
    here = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(here, "metrics", "calls_seen.train.py"), "w") as f:
        f.write("def read(run):\n    return float(run['window']['calls'])\n")
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    bench["per_layer"].append({
        "name": "calls_seen.train", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "step", "moves": "train_img_s",
        "workloads": ["tiny.ml"]})
    json.dump(bench, open(os.path.join(tiny_root, "BENCHMARK.json"), "w"))
    rc, result, err = run_tiny(tiny_root, "run", [
        "--workload", "tiny.ml", "--seed", "4000000001", "--seconds", "1",
        "--trace", "1"])
    assert rc == 0, err[-3000:]
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_seen.train"]["value"] == result["attempted"]
    assert "mfu.train" in result["metrics"]
    assert list(result)[-1] == "checks"
