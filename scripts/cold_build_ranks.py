#!/usr/bin/env python3
"""Time a cold start of the kernel builds under data parallelism.

    python3 scripts/cold_build_ranks.py [--ranks 4]

A data-parallel run whose checkout has no built kernels yet makes every
rank build each library it loads, at first use (`ops/kernels/_build.py`:
one nvcc per library, renamed into place when done, so ranks that build
the same library at once all end with a whole file). This times that
start: `--ranks` processes (gloo ranks on the CPU, which load the
libraries without touching a card) that each load the five libraries into
one empty build directory, against one `_build.build` of all five (one
nvcc per source, all started together, as `chip_smoke.py`'s phase 2 does)
into another. Prints one JSON line with both wall times, each rank's, and
the host's CPU count. Needs nvcc; needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adaptsegnet_tpu_torch.ops.kernels import LIBRARIES, _build  # noqa: E402
from adaptsegnet_tpu_torch.parallel import group  # noqa: E402


def load_all(build_dir: str) -> float:
    """This rank's seconds to load every library from `build_dir`."""
    _build.BUILD_DIR = Path(build_dir)
    t0 = time.perf_counter()
    for name in LIBRARIES:
        _build.load(name)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    one_dir, ranks_dir = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        _build.BUILD_DIR = Path(one_dir)
        t0 = time.perf_counter()
        _build.build(list(LIBRARIES))
        one = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_rank = group.launch(load_all, args.ranks, cpu=True,
                                args=(ranks_dir,), timeout=1200)
        ranks = time.perf_counter() - t0
        built = sorted(p.name for p in Path(ranks_dir).glob("*.so"))
    finally:
        shutil.rmtree(one_dir, ignore_errors=True)
        shutil.rmtree(ranks_dir, ignore_errors=True)
    print(json.dumps({
        "one_build_s": round(one, 1), "ranks": args.ranks,
        "ranks_launch_s": round(ranks, 1),
        "per_rank_s": [round(t, 1) for t in per_rank],
        "libraries": len(built), "cpus": os.cpu_count()}))
    return 0 if len(built) == len(LIBRARIES) else 1


if __name__ == "__main__":
    sys.exit(main())
