"""The device trace of a window: torch.profiler's CUDA activity (kernels,
copies and fills, as CUPTI records them), reduced to what the per-layer
metrics read.

* busy: the union of the kernels' and copies' intervals on the card
  (NCCL's kernels included: the card is occupied while they wait);
  user-annotation spans are not recorded (CUDA activity only), so nothing
  repeats a kernel's time;
* families: each hand-written kernel's records by the family whose KERNEL
  pattern its CUDA name matches (work/families); a second pass (SECOND_PASS)
  goes to the family of the hand-written kernel before it on its stream;
* the top device operations by name, and the idle gaps, each named by the
  host span (lib/window.py's `HostSpans`) around its middle.

The record counts are checked against the wrappers' `launches` counters by
the caller: a profiler that drops records must fail the window, not lower
its busy time.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch


def start() -> torch.profiler.profile:
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def device_events(prof, device_index: int) -> list[tuple[str, int, int, int]]:
    """(name, start ns, end ns, stream) of the kernels, copies and fills on
    card `device_index`, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if e.is_user_annotation() or e.device_index() != device_index:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns(),
                    e.device_resource_id()))
    out.sort(key=lambda r: r[1])
    return out


def union_ns(events, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1] that some event covers."""
    busy, end = 0, t0
    for _, s, e, _ in events:
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return busy


def by_family(events, families: dict) -> dict:
    """{family: {'records': main-kernel records, 'seconds': device seconds
    of its main kernels and second passes}}, `families` {name: module}."""
    mains = {f: re.compile(m.KERNEL) for f, m in families.items()}
    seconds = {f: re.compile(m.SECOND_PASS) for f, m in families.items()
               if m.SECOND_PASS}
    out = {f: {"records": 0, "seconds": 0.0} for f in families}
    last = {}  # stream -> family of its last hand-written kernel
    for name, s, e, stream in events:
        fam = next((f for f, rx in mains.items() if rx.search(name)), None)
        if fam is not None:
            out[fam]["records"] += 1
            last[stream] = fam
        elif any(rx.search(name) for rx in seconds.values()):
            fam = last.get(stream)
        if fam is not None:
            out[fam]["seconds"] += (e - s) / 1e9
    return out


def top_ops(events, k: int = 10) -> list[list]:
    """[[name, seconds]] of the k names with the most device time."""
    total = defaultdict(int)
    for name, s, e, _ in events:
        total[name[:120]] += e - s
    return [[n, ns / 1e9] for n, ns in
            sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, t0: int, t1: int, spans, k: int = 10) -> list[list]:
    """[[host span, seconds]] of the k longest gaps in [t0, t1] with no
    device event, each named by the host span around its middle
    (`spans.at(ns)`)."""
    gaps, end = [], t0
    for _, s, e, _ in events:
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[spans.at((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:k]
            if b > a]
