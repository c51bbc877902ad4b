"""Step timing and torch.profiler traces with a per-op table.

Counterpart of adaptsegnet_tpu/utils/profiling.py: `StepTimer` (wall-clock
per step, the card synchronised at each stop), `trace(dir)` (a
torch.profiler window written as a Chrome trace, in place of jax.profiler's
xplane) and `op_stats(dir)`, which reads the newest trace back into rows
with the JAX package's keys {host_or_device, op_type, op_name, occurrences,
self_us}, sorted by self time. Device rows are the CUDA kernels, copies and
fills (the hand-written kernels under their CUDA names); host rows are the
ATen operators, each by its own time (its children's time taken out).
`op_type` is the kernel's function name without namespaces, template
arguments and parameters (an operator's or a copy's own name), so the
rollup by op type sums a kernel's instances.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Optional

import numpy as np
import torch

_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_ANON = re.compile(r"\(anonymous namespace\)::")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock per-step timing with warmup discard and percentiles; each
    stop waits for the card."""

    def __init__(self, warmup: int = 2):
        self._warmup = warmup
        self._times: list[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def start(self):
        _sync()
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        _sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self._warmup:
            self._times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self._times)) if self._times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self._times)) if self._times else float("nan")

    @property
    def best(self) -> float:
        return float(np.min(self._times)) if self._times else float("nan")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a card),
    written to `log_dir` as a Chrome trace (view in Perfetto or
    chrome://tracing); yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def op_type(name: str) -> str:
    """A kernel's function name without namespaces, template arguments and
    parameters ('void ns::conv_sm90_kernel<2, 256>(...)' ->
    'conv_sm90_kernel'); other names unchanged."""
    short = _ANON.sub("", name).removeprefix("void ")
    cut = min((i for i in (short.find("<"), short.find("(")) if i > 0),
              default=len(short))
    return short[:cut].split("::")[-1] if cut < len(short) else name


def _host_self_us(events: list[dict]) -> list[tuple[dict, float]]:
    """(event, its duration minus its direct children's) for nested
    host events, per thread."""
    out = []
    by_thread: dict = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[list] = []  # [event, end, children's time]
        for e in evs:
            while stack and e["ts"] >= stack[-1][1]:
                top = stack.pop()
                out.append((top[0], top[0]["dur"] - top[2]))
            if stack:
                stack[-1][2] += e["dur"]
            stack.append([e, e["ts"] + e["dur"], 0.0])
        out += [(top[0], top[0]["dur"] - top[2]) for top in stack]
    return out


def op_stats(trace_dir: str, device_only: bool = True) -> list[dict]:
    """Per-op stats from the NEWEST trace under a `trace()` directory.

    Rows {host_or_device, op_type, op_name, occurrences, self_us}, one per
    kernel / operator name, sorted by self time (descending).
    `device_only` keeps the rows whose host_or_device == "Device" (a run
    without a card has none: pass False there)."""
    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace (.json) under {trace_dir}")
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    agg: dict = {}

    def add(kind, typ, name, us):
        row = agg.setdefault((kind, name), {
            "host_or_device": kind, "op_type": typ, "op_name": name,
            "occurrences": 0, "self_us": 0.0})
        row["occurrences"] += 1
        row["self_us"] += float(us)

    for e in events:
        cat = e.get("cat", "")
        if cat == "kernel":
            add("Device", op_type(e["name"]), e["name"], e["dur"])
        elif cat in _DEVICE_CATEGORIES:
            add("Device", cat, e["name"], e["dur"])
    if not device_only:
        host = [e for e in events if e.get("cat") == "cpu_op"]
        for e, us in _host_self_us(host):
            add("Host", e["name"], e["name"], us)
    rows = list(agg.values())
    if device_only:
        rows = [r for r in rows if r["host_or_device"] == "Device"]
    rows.sort(key=lambda r: -r["self_us"])
    return rows


def print_op_stats(rows: list[dict], top: int = 40, iters: int = 1):
    """Top-N ops by self time + a rollup by op type."""
    total = sum(r["self_us"] for r in rows)
    print(f"total self time: {total / 1e3:.2f} ms over "
          f"{iters} iters -> {total / 1e3 / max(iters, 1):.2f} ms/step")
    print(f"{'op type':<28} {'occ':>4} {'self ms':>9} {'%':>5}  name")
    for r in rows[:top]:
        print(f"{str(r.get('op_type') or ''):<28} "
              f"{str(r.get('occurrences') or ''):>4} "
              f"{r['self_us'] / 1e3:>9.3f} "
              f"{100 * r['self_us'] / max(total, 1e-9):>5.1f}  "
              f"{str(r.get('op_name') or '')[:70]}")
    agg: dict = {}
    for r in rows:
        key = r.get("op_type") or "?"
        agg[key] = agg.get(key, 0.0) + r["self_us"]
    print("\nrollup by op type:")
    for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {k:<32} {v / 1e3:>9.3f} ms  "
              f"{100 * v / max(total, 1e-9):>5.1f}%")
