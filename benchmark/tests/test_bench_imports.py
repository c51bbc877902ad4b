"""Nothing the benchmark runs imports JAX, flax or the JAX package (whole
top-level names: the port's adaptsegnet_tpu_torch passes), and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "adaptsegnet_tpu"}


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        if "tests" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "adaptsegnet_tpu_torch" not in top_level_imports(path), path


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.calibrate\n"
            "from benchmark.lib import harness, registry\n"
            "for c in ('multilevel.train-b16', 'warper.train-b32', "
            "'multilevel.eval-b16'):\n"
            "    registry.cell(c)\n"
            "registry.families()\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "adaptsegnet_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    exits nonzero and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch\nsys.path.insert(0, %r)\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'multilevel.eval-b16', '--seed', "
            "'1', '--seconds', '1'], device=torch.device('cpu')))" % str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert "adaptsegnet_tpu_torch" in p.stderr
