"""The traced window: steps of the cell's own loop under ``torch.profiler``,
after the measured window and outside it.

Each step runs inside the benchmark's own spans (``SPANS``: ``env.step``,
``host.read`` where the driver reads its outputs back, ``trainer.collect``
and ``trainer.update``). The trace gives:

- ``steps`` and ``window_s`` (the traced steps and their wall time, which
  the profiler inflates);
- ``busy_s``: seconds in which some device activity ran (the union of the
  device events), and ``work_s``: the same without NCCL's kernels, which
  occupy the card while a rank waits for the others;
- ``pulse_kernel_s``: device seconds of ``pulse_kernel`` launches,
  ``other_device_s``: of every other device event, ``collective_s``: of
  NCCL's kernels, and ``collective_durations``: each NCCL kernel's
  seconds in the order they started (a driver on several cards takes
  each collective's least over the ranks from them);
- ``pulse_ops``, ``pulse_bytes``: the frozen price of the traced steps'
  pulses (``perfbench/roofline/llgs.py``) from the actions' durations;
- ``pulse_launches_profiler`` and ``pulse_launches_counter``: the
  profiler's count of ``pulse_kernel`` launches beside the program's
  counter, printed, and read by no metric;
- ``device_ops`` and ``idle_gaps``: the breakdown's top ten of each.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.lib import program, trace
from perfbench.roofline import llgs

PULSE_KERNEL = "pulse_kernel"
# The benchmark's own spans around its calls into the port.
SPANS = ("env.step", "host.read", "trainer.collect", "trainer.update")


def profiled(ctx, step: Callable[[], np.ndarray], n_steps: int) -> dict:
    """Runs ``step`` ``n_steps`` times under the profiler. ``step`` runs one
    step in the cell's own way and returns the durations its pulse was
    given."""
    activities = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    ctx.sync()
    launches0 = program.pulse_launches()
    durations = []
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            durations.append(step())
        ctx.sync()
        window_s = time.perf_counter() - t0
    launches = program.pulse_launches() - launches0
    device, host = trace.read_profile(prof)
    starts = [s for name, s, _ in host if name in SPANS]
    ends = [e for name, _, e in device + host]
    first = min(starts) if starts else 0.0
    last = max(ends) if ends else first
    pulse_s = sum(trace.totals(device, PULSE_KERNEL).values())
    ops = nbytes = 0.0
    for d in durations:
        if isinstance(d, torch.Tensor):
            d = d.cpu().numpy()
        o, b = llgs.pulse_work(d, ctx.config)
        ops, nbytes = ops + o, nbytes + b
    out = dict(
        steps=n_steps,
        window_s=window_s,
        busy_s=trace.busy_seconds(device),
        work_s=trace.busy_seconds([e for e in device if "nccl" not in e[0].lower()]),
        pulse_kernel_s=pulse_s,
        other_device_s=sum(e - s for name, s, e in device if PULSE_KERNEL not in name) * 1e-6,
        collective_s=sum(e - s for name, s, e in device if "nccl" in name.lower()) * 1e-6,
        collective_durations=[(e - s) * 1e-6 for name, s, e in sorted(device, key=lambda x: x[1])
                              if "nccl" in name.lower()],
        pulse_ops=ops,
        pulse_bytes=nbytes,
        pulse_launches_profiler=trace.count(device, PULSE_KERNEL),
        pulse_launches_counter=launches,
        device_ops=trace.top(trace.totals(device)),
        idle_gaps=trace.top(trace.idle_gaps(device, host, first, last)),
    )
    if pulse_s > 0 and ops > 0:
        out["pulse_roofline_bound"] = llgs.roofline_share(ops, nbytes, pulse_s)[1]
    ctx.note(traced_steps=n_steps, pulse_launches_profiler=out["pulse_launches_profiler"],
             pulse_launches_counter=launches, device_events=len(device))
    return out

