"""What the system under test records of itself: the spans of
``spintorque_tpu_torch.utils.profiling`` (its process-wide ``PROFILER``),
read after a run. Beside ``program.py``, which drives the port, this is
the benchmark's one other module that imports it, and it only reads.

A port that records no such span, or has no span store at all (an older
commit), reads as None: a metric read from it is then left out of the
result line."""

from __future__ import annotations

from typing import Optional


def span_seconds(name: str) -> Optional[float]:
    """Seconds spent in every span ``name`` the port recorded in this
    process, or None where it recorded none."""
    from spintorque_tpu_torch.utils import profiling

    store = getattr(profiling, "PROFILER", None)
    spans = getattr(store, "spans", None)
    if spans is None:
        return None
    ns = [r.end_ns - r.start_ns for r in spans() if r.name == name]
    return sum(ns) * 1e-9 if ns else None
