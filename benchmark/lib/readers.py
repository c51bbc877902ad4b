"""The arithmetic of the per-layer metrics; each metric's file under
benchmark/metrics names the reader it uses. A reader takes the run's
readings (run.py `readings`) and returns a number, or None where the run
has nothing to read, and the metric is then left out of the result line.
"""

from __future__ import annotations

import statistics

from benchmark.lib.peaks import PEAK_FLOPS


def _window_s(run: dict) -> float:
    w = run["window"]
    return (w["t1"] - w["t0"]) / 1e9


def mfu(run: dict):
    """The model's operations over the window's steps, as a share of the
    cards' bf16 peak over the window."""
    ops = run["plan"]["model_ops"] * run["window"]["calls"]
    return 100.0 * ops / (_window_s(run) * run["chips"] * PEAK_FLOPS["bf16"])


def call_p90_ms(run: dict):
    """The 90th percentile of the time between the card's finishing one
    call and the next (CUDA events on the stream)."""
    ms = run["window"]["call_ms"]
    if len(ms) < 10:
        return None
    return statistics.quantiles(ms, n=10)[-1]


def host_enqueue_ms(run: dict):
    """The median host time of one call into the timed path."""
    return statistics.median(run["window"]["enqueue_ms"])


def device_idle_pct(run: dict):
    """The share of the traced window with no kernel or copy on the card,
    averaged over the cards."""
    tr = run.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s_mean"] / tr["window_s"])


def roofline(family: str):
    def read(run: dict):
        """The family's least time (each launch's operations at its peak or
        bytes at the HBM rate, whichever is longer) over its device time."""
        tr = run.get("trace")
        if tr is None:
            return None
        fam = tr["families"].get(family)
        if not fam or fam["seconds"] <= 0:
            return None
        return 100.0 * fam["least_s"] / fam["seconds"]
    return read
