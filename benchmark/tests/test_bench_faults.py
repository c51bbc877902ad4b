"""The check that decides `correct` at a tiny size on the CPU: the program
passes limits that its planted faults and the fp8 control fail. The limits
here are the tiny copy's own (set from the readings of this test's
program runs); the cells' limits are set on the card (PERF.md)."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.tests.conftest import run_tiny

SEED = ["--seed", "4000000003", "--seconds", "1", "--trace", "0"]


def set_limits(root: str, cell: str, limits: dict) -> None:
    json.dump(limits, open(os.path.join(root, "benchmark", "limits", cell + ".json"), "w"))


TRAIN_LIMITS = {"loss_gap": 0.05, "grad_gap": 0.01, "change_gap": 0.05,
                "grad_dev": 0.03}


@pytest.mark.parametrize("cell,fault,limits", [
    ("tiny.ml", None, TRAIN_LIMITS),
    ("tiny.ml", "state_unchanged", TRAIN_LIMITS),
    ("tiny.ml", "half_batch", TRAIN_LIMITS),
    ("tiny.wp", "state_unchanged", {**TRAIN_LIMITS, "stats_gap": 0.05}),
    ("tiny.ev", None, {"mask_gap": 0.02, "hist_mismatch": 0}),
    ("tiny.ev", "answer_altered", {"mask_gap": 0.02, "hist_mismatch": 0}),
    ("tiny.dp2", None, TRAIN_LIMITS),
    ("tiny.dp2", "no_exchange", TRAIN_LIMITS),
])
def test_fault_fails_correct(tiny_root, cell, fault, limits):
    set_limits(tiny_root, cell, limits)
    rc, result, err = run_tiny(tiny_root, "run", ["--workload", cell, *SEED],
                               fault=fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is (fault is None), result["checks"]


@pytest.fixture(scope="module")
def tiny_calibration(tiny_root) -> dict:
    rc, last, err = run_tiny(tiny_root, "calibrate", [
        "--workload", "tiny.ml", "--seeds", "4000000005,4000000006",
        "--control-seeds", "4000000007"])
    assert rc == 0, err[-3000:]
    return last["summary"]


def test_control_reads_three_times_the_program(tiny_calibration):
    """calibrate.py at the tiny size: the fp8 control's smallest reading of
    some number is at least three times the program's largest."""
    summary = tiny_calibration
    assert any(summary["control_min"][k] >= 3 * summary["lower"][k]
               for k in summary["lower"]), summary


@pytest.mark.parametrize("fault,number", [("half", "grad_dev"),
                                          ("d1_split", "grad_dev.D1")])
def test_fault_reads_ten_times_the_program(tiny_calibration, fault, number):
    """calibrate.py's planted faults at the tiny size: each reads at least
    ten times the program's largest on the gradient's deviation (a D1
    weight gradient that loses half its sum moves D1's update under Adam
    by almost nothing, so only the gradient itself shows it)."""
    summary = tiny_calibration
    assert summary[fault + "_min"][number] >= 10 * summary["lower"][number], summary
