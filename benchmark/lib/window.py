"""The measured window: the timed path called as its users call it, for a
fixed length of host time, with no synchronisation inside but the one a
user's loop makes.

* Train: `train/loop.py`'s order: enqueue step i, then read step i-1's
  metrics (which waits for it), so the host enqueues one step ahead of the
  card. In a group the ranks stop together: each step carries this rank's
  vote (the window's time is up) in the metrics' all-reduce, and every rank
  reads the summed vote one step behind, as the loop's stop vote does.
* Eval: calls back to back, each call's histogram added into the run's on
  the card; nothing is read back inside the window.

Both record a CUDA event after each call (the step time on the card's
stream, read after the window) and the host clock around each call (the
enqueue), and keep named host spans for the trace's idle gaps. The rate is
all the work of the window over all its time: from the first enqueue to
the card's finishing the last call.
"""

from __future__ import annotations

import math
import time

import torch


class HostSpans:
    """What the host was doing, as (name, start ns, end ns) on the
    profiler's clock (time.time_ns)."""

    def __init__(self):
        self.spans = []

    def add(self, name: str, a: int, b: int) -> None:
        self.spans.append((name, a, b))

    def at(self, ns: int) -> str:
        for name, a, b in self.spans:
            if a <= ns < b:
                return name
        return "outside the host's spans"


def _mark(device: torch.device):
    """A point on the card's stream (a CUDA event), or the host clock on
    the CPU, where the benchmark's tests drive the harness."""
    if device.type != "cuda":
        return time.perf_counter_ns()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _events_ms(marks) -> list[float]:
    if marks and isinstance(marks[0], int):
        return [(b - a) / 1e6 for a, b in zip(marks, marks[1:])]
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(state, step, batches, seconds: float, per_step_images: int,
          group=None) -> dict:
    """Run steps on `batches` (cycled) for `seconds` of host time."""
    spans = HostSpans()
    device = batches[0]["images"].device
    vote = None
    if group is not None and group.active():
        vote = torch.zeros((), device=device)
    enqueue_ms, failed = [], 0
    _sync(device)
    if vote is not None:
        group.all_reduce_sum(vote)
        _sync(device)
    t0 = time.time_ns()
    events = [_mark(device)]
    deadline = t0 + int(seconds * 1e9)
    pending, steps, stop = None, 0, False
    while True:
        batch = batches[steps % len(batches)]
        a = time.time_ns()
        if vote is not None:
            vote.fill_(float(a >= deadline))
            metrics = step(state, batch, {"stop": vote})
        else:
            metrics = step(state, batch)
        b = time.time_ns()
        spans.add("step enqueue", a, b)
        enqueue_ms.append((b - a) / 1e6)
        events.append(_mark(device))
        steps += 1
        if pending is not None:
            vals = {k: float(v) for k, v in pending.items()}
            c = time.time_ns()
            spans.add("metrics read, waiting for the step before", b, c)
            if vote is not None:
                stop = vals.pop("stop") > 0
            failed += not all(math.isfinite(v) for v in vals.values())
        pending = metrics
        if stop if vote is not None else time.time_ns() >= deadline:
            break
    c = time.time_ns()
    vals = {k: float(v) for k, v in pending.items()}
    _sync(device)
    t1 = time.time_ns()
    spans.add("metrics read, waiting for the last step", c, t1)
    vals.pop("stop", None)
    failed += not all(math.isfinite(v) for v in vals.values())
    return {"t0": t0, "t1": t1, "calls": steps,
            "images": steps * per_step_images, "enqueue_ms": enqueue_ms,
            "call_ms": _events_ms(events), "spans": spans,
            "failed": failed}


def evaluate(fn, batches, seconds: float, classes: int, per_call_images: int):
    """Call `fn(images, labels)` on `batches` (cycled) for `seconds`; keeps
    the last (masks, histogram) of each batch of the pool."""
    spans = HostSpans()
    device = batches[0]["images"].device
    total = torch.zeros((classes, classes), dtype=torch.int64, device=device)
    kept, enqueue_ms = {}, []
    _sync(device)
    t0 = time.time_ns()
    events = [_mark(device)]
    deadline = t0 + int(seconds * 1e9)
    calls = 0
    while True:
        i = calls % len(batches)
        a = time.time_ns()
        masks, hist = fn(batches[i]["images"], batches[i]["labels"])
        total.add_(hist)
        b = time.time_ns()
        spans.add("eval enqueue", a, b)
        enqueue_ms.append((b - a) / 1e6)
        events.append(_mark(device))
        kept[i] = (masks, hist)
        calls += 1
        if b >= deadline:
            break
    c = time.time_ns()
    _sync(device)
    t1 = time.time_ns()
    spans.add("waiting for the card after the last call", c, t1)
    return {"t0": t0, "t1": t1, "calls": calls,
            "images": calls * per_call_images, "enqueue_ms": enqueue_ms,
            "call_ms": _events_ms(events), "spans": spans, "kept": kept,
            "total": total}
