"""Reduction of a ``torch.profiler`` trace to device times.

The profiler's Chrome trace is written to the run's temporary directory,
read and deleted. Device activity is every event of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; host activity is every
``cpu_op``, ``user_annotation`` (the benchmark's own spans) and
``cuda_runtime`` event. Times are on one clock, in microseconds.

Launch counts from the profiler are printed beside the program's own
counters and feed no metric: the profiler has been seen to miscount.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime"}


def read_profile(prof) -> Tuple[List[Tuple[str, float, float]], List[Tuple[str, float, float]]]:
    """(device events, host events) of a finished profile, each a list of
    (name, start_us, end_us)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        item = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat in DEVICE_CATS:
            device.append(item)
        elif cat in HOST_CATS:
            host.append(item)
    return device, host


def merged(intervals: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(device) -> float:
    return sum(e - s for s, e in merged(device)) * 1e-6


def totals(device, match=None) -> Dict[str, float]:
    """Device seconds by event name (of the events whose name contains
    ``match``, when given)."""
    out: Dict[str, float] = defaultdict(float)
    for name, s, e in device:
        if match is None or match in name:
            out[name] += (e - s) * 1e-6
    return dict(out)


def count(device, match: str) -> int:
    return sum(1 for name, _, _ in device if match in name)


def top(table: Dict[str, float], k: int = 10) -> List[List]:
    return [[n, s] for n, s in sorted(table.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(device, host, start_us: float, end_us: float) -> Dict[str, float]:
    """Seconds the device sat idle inside [start_us, end_us], by what the
    host was doing when each gap began: the innermost host event that
    covers the gap's start ("host idle" where none does)."""
    busy = merged(device)
    gaps, t = [], start_us
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, end_us)))
        t = max(t, e)
        if t >= end_us:
            break
    if t < end_us:
        gaps.append((t, end_us))
    host_sorted = sorted(host, key=lambda x: x[1])
    out: Dict[str, float] = defaultdict(float)
    active: List[Tuple[str, float, float]] = []  # host events open at the sweep's time
    i = 0
    for gs, ge in gaps:  # in order of their start
        while i < len(host_sorted) and host_sorted[i][1] <= gs:
            active.append(host_sorted[i])
            i += 1
        active = [h for h in active if h[2] > gs]
        if ge <= gs:
            continue
        inner = min(active, key=lambda h: h[2] - h[1], default=None)
        out["host idle" if inner is None else inner[0]] += (ge - gs) * 1e-6
    return dict(out)
