"""Performance profiling: named host timers, device traces and a timing
helper.

PyTorch counterpart of ``spintorque_tpu/utils/profiling.py``:
``PerformanceProfiler`` (named wall-clock timers and counters),
``device_trace`` (a ``torch.profiler`` trace of CPU and CUDA activity,
written as a Chrome trace) and ``block_and_time`` (steady-state wall clock
of a callable, synchronizing the card around the timed calls).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict

import numpy as np
import torch


class PerformanceProfiler:
    """Named wall-clock timers and counters."""

    def __init__(self):
        self._times: Dict[str, list] = defaultdict(list)
        self._counters: Dict[str, int] = defaultdict(int)
        self._active: Dict[str, float] = {}

    def start_timer(self, name: str) -> None:
        self._active[name] = time.perf_counter()

    def end_timer(self, name: str) -> float:
        start = self._active.pop(name, None)
        if start is None:
            return 0.0
        elapsed = time.perf_counter() - start
        self._times[name].append(elapsed)
        return elapsed

    @contextlib.contextmanager
    def time_operation(self, name: str):
        self.start_timer(name)
        try:
            yield
        finally:
            self.end_timer(name)

    def increment_counter(self, name: str, amount: int = 1) -> None:
        self._counters[name] += amount

    def get_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": dict(self._counters), "timers": {}}
        for name, samples in self._times.items():
            arr = np.asarray(samples)
            out["timers"][name] = {
                "count": len(arr),
                "total_s": float(arr.sum()),
                "mean_s": float(arr.mean()),
                "max_s": float(arr.max()),
            }
        return out

    def reset(self) -> None:
        self._times.clear()
        self._counters.clear()
        self._active.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where torch
    sees a card) and write ``<log_dir>/trace.json``, a Chrome trace that
    Perfetto reads. Yields the profiler, whose ``key_averages()`` give the
    kernels' device times. Synchronize the card inside the block so the
    trace holds the work it launched:

        with device_trace("traces") as prof:
            state, ts = env.step(state, action)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def block_and_time(fn, *args, iters: int = 10, warmup: int = 1, **kwargs):
    """(mean seconds per call, last output) of ``fn(*args, **kwargs)`` over
    ``iters`` calls after ``warmup``, by the host clock between two
    ``torch.cuda.synchronize()`` calls (no synchronize without a card)."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    sync()
    return (time.perf_counter() - t0) / iters, out
