"""On the card (marker `card`): the control and the planted faults at the
cell's own size, on three seeds, against the program on three others;
skips without a card.
Run with: python -m pytest benchmark/tests/test_bench_card.py -m card"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("cell", ["multilevel.train-b16", "warper.train-b32",
                                  "multilevel.eval-b16"])
def test_control_fails_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "calibrate.py"),
         "--workload", cell, "--seeds", "5000000001,5000000002,5000000003",
         "--control-seeds", "5000000004,5000000005,5000000006"],
        cwd=REPO, capture_output=True, text=True, timeout=1800, check=True)
    summary = json.loads(out.stdout.strip().splitlines()[-1])["summary"]
    limits = json.load(open(os.path.join(REPO, "benchmark", "limits", cell + ".json")))
    assert all(summary["lower"][k] <= v for k, v in limits.items())
    assert any(summary["control_min"][k] > v for k, v in limits.items())
    for fault in [k for k in summary if k.endswith("_min") and k != "control_min"]:
        assert any(summary[fault][k] > v for k, v in limits.items()), fault
