"""Driver ``array``: a batch of coupled crossbar arrays (SpinTorqueArray-v0)
stepped in programs of eager steps, actions drawn on the card, the host
waiting for the card only at the end of each block of programs to read
the clock (a closed loop with the policy on the card), as the ``rollout``
driver steps SpinTorque-v0.

Workload keys: ``batch``, ``program_steps``, ``block_programs``,
``warmup_programs``, ``trace_programs``, ``traffic`` (``index``, ``current``
and ``duration``: inclusive integer and float ranges of uniform draws) and
``check``.

Records: ``setup_s``; ``window`` (its ``seconds``, ``steps`` and
``env_steps``: arrays x steps); with the trace on, ``array_spans`` (the
port's ``array.step`` and ``array.sweep`` seconds over a window of steps
with the port's tracing on and no profiler, None where the port records no
such span) and ``trace`` (a second window under ``torch.profiler``: the
steps, their wall, the device's busy seconds, its events and the
breakdown). The array runs no ``pulse_kernel``, so nothing is priced.

The check (``check_run``) recomputes each sampled step with the plain
reference (``perfbench/reference/array.py``) at the whole batch, from the
state the step started from, and the reset the window started from:

- ``pattern_err``: the largest |difference| of a component of m after the
  sweep, before the auto-reset;
- ``obs_err``: the largest |difference| in the (rows, cols, 6) observation
  after the auto-reset, each entry over the reference's largest |value|
  there;
- ``reward_err``: the largest |difference| of the reward;
- ``state_err``: as ``obs_err``, over the step's flags (terminated,
  truncated, as 0 or 1), the next state's fields (pattern, target, step,
  energy, episode return; its counter, 0 or 1 for equal or not) and the
  initial reset.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.lib import array_program, trace
from perfbench.lib.check import Sample, _max_abs, _scaled
from perfbench.lib.traffic import ACTION_STREAM, subseed
from perfbench.reference import array as ref

NUMBERS = ("pattern_err", "obs_err", "reward_err", "state_err")


class Actions:
    """One step's (B, 3) float32 ``[index, I, dt]`` actions, drawn on the
    card: the index uniform over the integers of ``index``, I and dt uniform
    over their ranges."""

    def __init__(self, traffic: Dict, devices: int, batch: int, seed: int, device):
        lo, hi = (int(x) for x in traffic["index"])
        if not 0 <= lo <= hi < devices:
            raise ValueError(f"index range {lo}-{hi} outside the {devices} devices")
        self.lo, self.count = lo, hi - lo + 1
        self.current = tuple(float(x) for x in traffic["current"])
        self.duration = tuple(float(x) for x in traffic["duration"])
        self.batch, self.device = batch, device
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(subseed(seed, ACTION_STREAM))

    def __call__(self) -> torch.Tensor:
        u = torch.rand((3, self.batch), generator=self.generator, dtype=torch.float32,
                       device=self.device)
        index = torch.floor(u[0] * self.count).clamp_(max=self.count - 1) + self.lo
        (clo, chi), (dlo, dhi) = self.current, self.duration
        return torch.stack([index, clo + (chi - clo) * u[1], dlo + (dhi - dlo) * u[2]], dim=-1)


def run(ctx):
    wl = ctx.workload
    batch, steps = wl["batch"], wl["program_steps"]
    env = array_program.make_env(ctx.config, batch, ctx.device, control=ctx.control)
    if ctx.patch is not None:
        ctx.patch(env)
        array_program.carry_fault(env)
    actions = Actions(wl["traffic"], env.config.n_devices, batch, ctx.seed, ctx.device)
    state, _ = env.reset(ctx.env_seed)
    start = state

    for _ in range(wl["warmup_programs"] * steps):
        state, _ = env.step(state, actions())
    ctx.sync()
    setup_s = time.time() - ctx.process_start

    block = wl["block_programs"] * steps
    kept, done = [], 0
    t0 = time.perf_counter()
    while True:
        for _ in range(block):
            action = actions()
            nxt, ts = env.step(state, action)
            if ctx.sampled(done):
                kept.append(Sample(state, action, nxt, ts))
            state = nxt
            done += 1
        ctx.sync()
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    records = dict(
        setup_s=setup_s,
        window=dict(seconds=elapsed, steps=done, env_steps=done * batch),
        attempted=done * batch,
        failed=0,
        memory_peak_bytes=(torch.cuda.max_memory_allocated(ctx.device)
                           if ctx.device.type == "cuda" else 0),
    )
    if ctx.trace:
        n = wl["trace_programs"] * steps
        since = array_program.span_count()
        with array_program.tracing():
            for _ in range(n):
                state, _ = env.step(state, actions())
            ctx.sync()
        records["array_spans"] = array_program.step_spans(since)
        records["trace"] = _profiled(ctx, env, actions, state, n)
    return records, start, kept


def _profiled(ctx, env, actions, state, n_steps: int) -> Dict:
    """``n_steps`` steps under ``torch.profiler``, each in the benchmark's
    ``env.step`` span."""
    activities = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    ctx.sync()
    updates0 = array_program.device_updates()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            action = actions()
            with record_function("env.step"):
                state, _ = env.step(state, action)
        ctx.sync()
        window_s = time.perf_counter() - t0
    updates = array_program.device_updates()
    device, host = trace.read_profile(prof)
    starts = [s for name, s, _ in host if name == "env.step"]
    ends = [e for _, _, e in device + host]
    first = min(starts) if starts else 0.0
    last = max(ends) if ends else first
    out = dict(
        steps=n_steps,
        window_s=window_s,
        busy_s=trace.busy_seconds(device),
        work_s=trace.busy_seconds([e for e in device if "nccl" not in e[0].lower()]),
        device_events=len(device),
        device_updates=None if updates is None else updates - updates0,
        device_ops=trace.top(trace.totals(device)),
        idle_gaps=trace.top(trace.idle_gaps(device, host, first, last)),
    )
    ctx.note(traced_steps=n_steps, device_events_per_step=len(device) / n_steps,
             device_updates_per_step=(None if out["device_updates"] is None
                                      else out["device_updates"] / n_steps))
    return out


def _program_state(s) -> ref.State:
    return ref.State(*(getattr(s, f).float() if getattr(s, f).is_floating_point()
                       else getattr(s, f) for f in ref.State._fields))


def _state_err(got: ref.State, want: ref.State) -> float:
    return max(_scaled(getattr(got, f), getattr(want, f)) for f in ref.State._fields)


def check_run(ctx, start, samples: List[Sample]) -> Dict:
    """The numbers of the comparison, and how many steps and rows it
    covered."""
    device = start.pattern.device
    env = ref.make_env(ctx.config, device)
    batch = ctx.workload["batch"]
    numbers = dict.fromkeys(NUMBERS, 0.0)
    with torch.no_grad():
        numbers["state_err"] = _state_err(_program_state(start),
                                          ref.reset(env, ctx.env_seed, batch, device))
        for x in samples:
            want = ref.step(env, _program_state(x.state), x.action.float(), x.state.seed,
                            x.state.counter)
            got = _program_state(x.state_out)
            pattern = x.ts.info["final_observation"][..., :3].reshape(want.pattern.shape)
            flags = torch.stack([x.ts.terminated, x.ts.truncated], dim=-1)
            want_flags = torch.stack([want.terminated, want.truncated], dim=-1)
            counter = float(x.state_out.counter != x.state.counter + 1)
            numbers["pattern_err"] = max(numbers["pattern_err"], _max_abs(pattern, want.pattern))
            numbers["obs_err"] = max(numbers["obs_err"], _scaled(x.ts.obs, want.obs))
            numbers["reward_err"] = max(numbers["reward_err"], _max_abs(x.ts.reward, want.reward))
            numbers["state_err"] = max(numbers["state_err"], _state_err(got, want.next_state),
                                       _scaled(flags, want_flags), counter)
    return dict(numbers=numbers, steps=len(samples), rows=len(samples) * batch)
