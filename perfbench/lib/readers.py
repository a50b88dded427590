"""Arithmetic shared by the metrics' readers (``perfbench/metrics/``).
Each reader takes a run's records and returns a number, or None where the
run holds nothing to read."""

from __future__ import annotations

from typing import Optional

import numpy as np

from perfbench.roofline import llgs


def idle_pct(records) -> Optional[float]:
    """The device's idle share of a step: 1 - (seconds a step in which the
    device worked, in the traced window) / (wall seconds a step in the same
    run's unprofiled window). The profiled window's own wall is no
    denominator: the profiler slows the host. NCCL's kernels are left out
    of the work: they occupy the card while a rank waits for the others."""
    t, w = records.get("trace"), records["window"]
    if not t or not t["steps"] or not w["steps"]:
        return None
    busy = t["work_s"] / t["steps"]
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / (w["seconds"] / w["steps"]))


def pulse_roofline_pct(records) -> Optional[float]:
    """The traced pulses' frozen price over ``pulse_kernel``'s device time."""
    t = records.get("trace")
    if not t or t["pulse_kernel_s"] <= 0.0:
        return None
    return llgs.roofline_share(t["pulse_ops"], t["pulse_bytes"], t["pulse_kernel_s"])[0]


def percentile(values, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, float), q)) if len(values) else None
