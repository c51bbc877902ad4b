"""Everything the harness runs is found by name, from files of its own, so
that a cell is added by adding files and an entry of BENCHMARK.json:

* a cell: its entry in BENCHMARK.json's `workloads`;
* a configuration: `benchmark/configs/<file>` named by the entry's
  `configs` item, and its work table `benchmark/work/configs/<name>.py`
  (`plan(cfg, traffic)`);
* a traffic mix: `benchmark/traffic/<traffic>.json`;
* the limits of a cell's `correct`: `benchmark/limits/<cell>.json`;
* a kernel family: `benchmark/work/families/<family>.py`;
* a per-layer metric: `benchmark/metrics/<metric>.py` (`read(run)`).
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_json(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """{'cell', 'cfg', 'traffic' (with 'cards'), 'limits', 'plan', 'end_to_end',
    'per_layer'} of the workload `name`."""
    bench = benchmark_json(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    entry = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    here = os.path.join(root, "benchmark")
    cfg = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    traffic["cards"] = entry["chips"]
    work = load_module(os.path.join(here, "work", "configs", conf["name"] + ".py"),
                       "work_" + conf["name"].replace("-", "_"))
    metrics = {"end_to_end": [], "per_layer": []}
    for kind in metrics:
        for m in bench[kind]:
            if name in m.get("workloads", [name]):
                metrics[kind].append(m)
    return {"cell": entry, "cfg": cfg, "traffic": traffic,
            "limits": load_json(os.path.join(here, "limits", name + ".json")),
            "plan": work.plan(cfg, traffic), **metrics}


def families(root: str = ROOT) -> dict:
    d = os.path.join(root, "benchmark", "work", "families")
    return {f[:-3]: load_module(os.path.join(d, f), "family_" + f[:-3])
            for f in sorted(os.listdir(d)) if f.endswith(".py")}


def metric_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    return load_module(path, "metric_" + name.replace(".", "_")).read
