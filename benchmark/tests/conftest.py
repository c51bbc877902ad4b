"""Fixtures of the benchmark's own tests (CPU): a copy of the benchmark in
a temporary directory with tiny cells added as files, and a helper that
runs the harness there in a subprocess, on the CPU, where the program's
kernels run their plain versions."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Tiny cells: the configurations at full width but 1-1-2-1 blocks and a
# 64x64 input (a 6-layer Warper), two images a card.
TINY = (("tiny.ml", "deeplabv2-r101-multilevel", "train", "multilevel.train-b16", 1),
        ("tiny.wp", "deeplabv2-r101-warper-srconly", "train", "warper.train-b32", 1),
        ("tiny.ev", "deeplabv2-r101-multilevel", "eval", "multilevel.eval-b16", 1),
        ("tiny.dp2", "deeplabv2-r101-multilevel", "train", "multilevel.train-b16", 2))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def add_tiny_cells(root: str, limit: float = 1.0) -> None:
    """Tiny configurations, traffic, work tables, limits and cells, added
    as files to the benchmark copy at `root` (no file of it edited but
    BENCHMARK.json's lists)."""
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    here = os.path.join(root, "benchmark")
    for name, config, path, like, chips in TINY:
        cfg = json.load(open(os.path.join(here, "configs", config + ".json")))
        cfg.update(name="tiny-" + config, blocks=[1, 1, 2, 1],
                   input_size=[64, 64], eval_output_size=[128, 128])
        if cfg.get("warper"):
            cfg["warper_num_layers"] = 6
        cfg_file = f"benchmark/configs/tiny-{config}.json"
        if not os.path.exists(os.path.join(root, cfg_file)):
            json.dump(cfg, open(os.path.join(root, cfg_file), "w"))
            shutil.copy(os.path.join(here, "work", "configs", config + ".py"),
                        os.path.join(here, "work", "configs", f"tiny-{config}.py"))
            bench["configs"].append({"name": "tiny-" + config, "source": "test",
                                     "file": cfg_file, "reduced": [], "why": "test"})
        traffic = json.load(open(os.path.join(
            here, "traffic", "train-b16.json" if path == "train" else "eval-b16.json")))
        traffic["batch_per_card"] = 2
        json.dump(traffic, open(os.path.join(here, "traffic", f"{name}.json"), "w"))
        limits = json.load(open(os.path.join(here, "limits", like + ".json")))
        json.dump({k: (limit if k != "hist_mismatch" else 0) for k in limits},
                  open(os.path.join(here, "limits", name + ".json"), "w"))
        bench["workloads"].append({"name": name, "config": "tiny-" + config,
                                   "traffic": name, "chips": chips, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"), indent=1)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny_cells(root)
    return root


def run_tiny(root: str, script: str, argv: list, fault: str | None = None,
             timeout: float = 600) -> tuple[int, dict | None, str]:
    """Run benchmark/<script>.py's main(argv) at `root` on the CPU, with
    the fault `fault` of benchmark/tests/faults.py planted; (exit code,
    the last stdout line as JSON or None, stderr)."""
    code = (
        "import sys, torch\n"
        f"from benchmark import {script}\n"
        "from benchmark.tests import faults\n"
        f"kw = {{'wrap': getattr(faults, {fault!r})}} if {fault!r} else {{}}\n"
        f"sys.exit({script}.main({argv!r}, device=torch.device('cpu'), **kw))\n")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr
