"""Performance profiling: the port's spans and counters, device traces and a
timing helper.

PyTorch counterpart of ``spintorque_tpu/utils/profiling.py``:
``PerformanceProfiler`` (named wall-clock timers and counters),
``device_trace`` (a ``torch.profiler`` trace of CPU and CUDA activity,
written as a Chrome trace) and ``block_and_time`` (steady-state wall clock
of a callable, synchronizing the card around the timed calls).

It is also the port's one tracing facility. ``PROFILER``, the process-wide
``PerformanceProfiler``, stores:

- **Spans**, named ``<module>.<phase>`` (``SPAN_NAMES``), entered with
  ``with span(name):`` at the port's layer boundaries. Tracing is off by
  default: ``span`` then tests one flag and returns a shared no-op context,
  allocating nothing and reading no clock. With tracing on
  (``tracing()``, ``device_trace``), each span keeps
  its start and end (``time.perf_counter_ns``: CLOCK_MONOTONIC, one clock
  for every process of a machine), its parent span, its self time (its
  duration less its child spans') and the step it belongs to (the index
  of the root span it lies under). Where a ``torch.profiler`` is recording,
  a span also enters ``record_function`` under its name, so the trace
  holds it as a ``user_annotation`` on the profiler's clock, around the
  kernels it launched.
- **Counters**: ``LaunchCounter``, plain integers raised under a lock,
  counted whatever the switch; ``counter(name)`` registers one by name.
  A CUDA graph's capture holds the counts of what it records
  (``held_counts``), and each replay adds them.

Two spans are recorded whatever the switch, since each happens once a
process: ``kernels.load`` (``ops._build``) and ``mesh.initialize``
(``parallel.distributed.initialize``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

# Every span the port enters, by layer (PERF.md's table names the metric
# each is for).
SPAN_NAMES = (
    # envs/spin_torque.py, SpinTorqueEnv.step
    "spin_torque.step", "spin_torque.replay",
    # envs/array.py, SpinTorqueArrayEnv.step
    "array.step", "array.replay", "array.decode", "array.sweep", "array.reward", "array.reset",
    "array.observe",
    # envs/skyrmion.py, SkyrmionRacetrackEnv.step
    "racetrack.step", "racetrack.replay", "racetrack.decode", "racetrack.forces",
    "racetrack.substeps", "racetrack.reward", "racetrack.observe", "racetrack.reset",
    # physics/integrator.py, ops/cuda_integrator.py: the pulse's host side
    "integrator.pulse", "cuda_integrator.dt_law", "cuda_integrator.coefficients",
    "cuda_integrator.sort", "cuda_integrator.launch",
    # rl/ppo.py, PPOTrainer
    "ppo.collect", "ppo.policy", "ppo.update", "ppo.gae", "ppo.normalize", "ppo.minibatch",
    "ppo.forward", "ppo.backward", "ppo.average_grads", "ppo.clip", "ppo.adam", "ppo.metrics",
    # parallel/
    "mesh.all_reduce", "mesh.initialize",
    # ops/_build.py
    "kernels.load",
)


# The counts held on this thread (``held_counts``), or None.
_held = threading.local()


class LaunchCounter:
    """The port's counter: ``count``, a plain integer that ``add`` raises
    under a lock, since kernels launch from several threads of a process
    (a serving refresh thread, a worker pool's drainer). Counts whatever
    the tracing switch, but inside ``held_counts`` on the same thread."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def add(self, amount: int = 1) -> None:
        held = getattr(_held, "counts", None)
        if held is not None:
            held[self] = held.get(self, 0) + amount
            return
        with self._lock:
            self.count += amount

    def reset(self) -> None:
        with self._lock:
            self.count = 0


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span's name, None for a root
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    self_ns: int  # the duration less the child spans'
    step: int  # the index of the root span it lies under, per thread
    thread: int


class PerformanceProfiler:
    """Named wall-clock timers, counters and spans."""

    def __init__(self):
        self._times: Dict[str, list] = defaultdict(list)
        self._counters: Dict[str, LaunchCounter] = {}
        self._counters_lock = threading.Lock()
        self._active: Dict[str, float] = {}
        self._spans: List[SpanRecord] = []

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

    def counter(self, name: str) -> LaunchCounter:
        """The counter registered under ``name``, made at its first use."""
        with self._counters_lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = LaunchCounter()
            return c

    def increment_counter(self, name: str, amount: int = 1) -> None:
        self.counter(name).add(amount)

    def counters(self) -> Dict[str, int]:
        """Every registered counter's count (zeros included)."""
        with self._counters_lock:
            return {name: c.count for name, c in self._counters.items()}

    def record_span(self, record: SpanRecord) -> None:
        self._spans.append(record)  # one append: atomic under the interpreter lock

    def spans(self) -> List[SpanRecord]:
        """The spans recorded so far, in the order they ended."""
        return list(self._spans)

    def span_stats(self, steps: int = 1, since: int = 0) -> Dict[str, Dict[str, float]]:
        """By span name: ``count``, ``total_ms`` and ``self_ms`` of the
        spans recorded after the first ``since``, each over ``steps`` (per
        step where ``steps`` is the window's step count)."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.spans()[since:]:
            s = out.setdefault(r.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            s["count"] += 1
            s["total_ms"] += (r.end_ns - r.start_ns) * 1e-6
            s["self_ms"] += r.self_ns * 1e-6
        return {name: {k: v / steps for k, v in s.items()} for name, s in out.items()}

    def get_stats(self) -> Dict[str, Any]:
        """``counters`` (those that counted) and ``timers``."""
        out: Dict[str, Any] = {"counters": {k: v for k, v in self.counters().items() if v},
                               "timers": {}}
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
        """Drops the timers and spans and zeroes the counters (registered
        counters stay registered: modules hold them)."""
        self._times.clear()
        with self._counters_lock:
            for c in self._counters.values():
                c.reset()
        self._active.clear()
        self._spans.clear()


PROFILER = PerformanceProfiler()
_tracing = False
_local = threading.local()


class _NoSpan:
    """The shared context of a span with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "step", "start", "child_ns", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.roots = 0
        self.parent = stack[-1] if stack else None
        if self.parent is None:
            self.step = _local.roots
            _local.roots += 1
        else:
            self.step = self.parent.step
        self.child_ns = 0
        stack.append(self)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _local.stack.pop()
        duration = end - self.start
        if self.parent is not None:
            self.parent.child_ns += duration
        PROFILER.record_span(SpanRecord(
            self.name, None if self.parent is None else self.parent.name, self.start, end,
            duration - self.child_ns, self.step, threading.get_ident()))
        return False


def span(name: str):
    """A context that records the span ``name`` while tracing is on, and a
    shared no-op one (one flag test) while it is off."""
    if not _tracing:
        return _NO_SPAN
    return _Span(name)


def always_span(name: str):
    """A span recorded whatever the switch: for what happens once a
    process (the kernels' load, the process group's start)."""
    return _Span(name)


def tracing_enabled() -> bool:
    return _tracing


@contextlib.contextmanager
def tracing():
    """Spans on for the block, on every thread of the process; then as
    they were."""
    global _tracing
    was, _tracing = _tracing, True
    try:
        yield PROFILER
    finally:
        _tracing = was


def counter(name: str) -> LaunchCounter:
    """``PROFILER.counter(name)``: the process-wide counter ``name``."""
    return PROFILER.counter(name)


@contextlib.contextmanager
def held_counts():
    """For a CUDA graph's capture, which records launches and runs none:
    inside the block, counters raised on this thread are held in the
    yielded dict ({counter: amount}) and not counted. Each replay of the
    graph then adds what the capture held (``LaunchCounter.add``), so the
    counters count what ran."""
    outer = getattr(_held, "counts", None)
    held = _held.counts = {}
    try:
        yield held
    finally:
        _held.counts = outer


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where torch
    sees a card), with the port's spans on, and write
    ``<log_dir>/trace.json``, a Chrome trace that Perfetto reads, in which
    the spans lie as ``user_annotation`` events around the work they
    launched. Yields the profiler, whose ``key_averages()`` give the
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
    with profile(activities=activities) as prof, tracing():
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
