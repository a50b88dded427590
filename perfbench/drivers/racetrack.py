"""Driver ``racetrack``: a batch of skyrmion racetracks (SkyrmionRacetrack-v0)
stepped in programs of steps, each step's Discrete(45) actions drawn on the
card before it (as a policy on the card acts on each step's observation),
the host waiting for the card only at the end of each block of programs to
read the clock (a closed loop), as the ``array`` driver steps
SpinTorqueArray-v0. The steps a block keeps for the check are copied to the
host after the block's synchronize, while the card waits anyway, in one
flat copy a dtype: held on the card through the window, each kept step
pins its output arenas, the caching allocator takes ~200 new segments, and
the host stalls for 50 ms to 1.6 s at some of them.

Workload keys: ``batch``, ``program_steps``, ``block_programs``,
``warmup_programs``, ``trace_programs``, ``traffic`` (``actions``: the
inclusive range of the uniform Discrete(45) draws) and ``check``. The
pinning sites are drawn from the run's seed.

Records: ``setup_s``; ``window`` (its ``seconds``, ``steps`` and
``env_steps``: tracks x steps); with the trace on, ``racetrack_spans`` (the
port's ``racetrack.step`` seconds over a window of steps with the port's
tracing on and no profiler, None where the port records no such span) and
``trace`` (a second window under ``torch.profiler``: the steps, their wall,
the device's busy seconds, the seconds of its events, its events and the
breakdown). The racetrack runs no ``pulse_kernel``, so nothing is priced:
``other_device_s``, the seconds of every device event other than
``pulse_kernel``, is all of the step's device time.

The check (``check_run``) recomputes each sampled step with the plain
reference (``perfbench/reference/racetrack.py``) at the whole batch, from
the state the step started from, and the reset the window started from.
Values span many decades (velocities from ~1e-4 m/s on a fresh undriven
track to ~1e8 on a driven one, rewards up to ~1e31 from the energy term),
so each entry is compared with its own magnitude, |got - want| / |want|
(0 where the two are equal, the largest float64 where ``want`` is an exact
zero and ``got`` is not), never with a column's largest:

- ``position_err``: the next state's positions;
- ``velocity_err``: the next state's velocities; only the small velocities
  of fresh undriven tracks carry the kick, the pinning and the gradient;
- ``obs_err``: the observation after the auto-reset and the one before it
  (``info["final_observation"]``);
- ``reward_err``: the reward;
- ``state_err``: the step's flags (terminated, truncated, as 0 or 1), the
  next state's step, energy and episode return, its counter (0 or 1 for
  equal or not) and the initial reset.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.lib import racetrack_program, trace
from perfbench.lib.check import Sample
from perfbench.lib.traffic import ACTION_STREAM, ENV_STREAM, subseed
from perfbench.reference import racetrack as ref

NUMBERS = ("position_err", "velocity_err", "obs_err", "reward_err", "state_err")
HOST = torch.device("cpu")
# The use of the run's seed that draws the pinning sites (after the three of
# lib/traffic.py).
PIN_STREAM = 3
N_ACTIONS = 45


class Actions:
    """One step's (B,) int64 Discrete(45) indices, drawn on the card uniform
    over the integers of ``actions``."""

    def __init__(self, traffic: Dict, batch: int, seed: int, device):
        lo, hi = (int(x) for x in traffic["actions"])
        if not 0 <= lo <= hi < N_ACTIONS:
            raise ValueError(f"action range {lo}-{hi} outside Discrete({N_ACTIONS})")
        self.lo, self.hi = lo, hi
        self.batch, self.device = batch, device
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(subseed(seed, ACTION_STREAM))

    def __call__(self) -> torch.Tensor:
        return torch.randint(self.lo, self.hi + 1, (self.batch,), generator=self.generator,
                             device=self.device)


def pin_seed(seed: int) -> int:
    return subseed(seed, PIN_STREAM)


def run(ctx):
    wl = ctx.workload
    batch, steps = wl["batch"], wl["program_steps"]
    env = racetrack_program.make_env(ctx.config, batch, ctx.device, pin_seed(ctx.seed),
                                     control=ctx.control)
    if ctx.patch is not None:
        ctx.patch(env)
        racetrack_program.carry_fault(env)
    actions = Actions(wl["traffic"], batch, ctx.seed, ctx.device)
    state, _ = env.reset(ctx.env_seed)
    start = state

    for _ in range(wl["warmup_programs"] * steps):
        state, _ = env.step(state, actions())
    ctx.sync()
    setup_s = time.time() - ctx.process_start

    kept, block, done = [], [], 0
    t0 = time.perf_counter()
    while True:
        for _ in range(wl["block_programs"] * steps):
            action = actions()
            nxt, ts = env.step(state, action)
            if ctx.sampled(done):
                block.append(Sample(state, action, nxt, ts))
            state = nxt
            done += 1
        ctx.sync()
        kept += to_host(block)
        block = []
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
        since = racetrack_program.span_count()
        with racetrack_program.tracing():
            for _ in range(n):
                state, _ = env.step(state, actions())
            ctx.sync()
        records["racetrack_spans"] = racetrack_program.step_spans(since)
        records["trace"] = _profiled(ctx, env, actions, state, n)
    return records, start, kept


def _profiled(ctx, env, actions, state, n_steps: int) -> Dict:
    """``n_steps`` steps under ``torch.profiler``, each in the benchmark's
    ``env.step`` span."""
    activities = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    ctx.sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            action = actions()
            with record_function("env.step"):
                state, _ = env.step(state, action)
        ctx.sync()
        window_s = time.perf_counter() - t0
    device, host = trace.read_profile(prof)
    starts = [s for name, s, _ in host if name == "env.step"]
    ends = [e for _, _, e in device + host]
    first = min(starts) if starts else 0.0
    last = max(ends) if ends else first
    ctx.note(traced_steps=n_steps, device_events_per_step=len(device) / n_steps)
    return dict(
        steps=n_steps,
        window_s=window_s,
        busy_s=trace.busy_seconds(device),
        other_device_s=sum(e - s for _, s, e in device) * 1e-6,
        work_s=trace.busy_seconds([e for e in device if "nccl" not in e[0].lower()]),
        device_events=len(device),
        device_ops=trace.top(trace.totals(device)),
        idle_gaps=trace.top(trace.idle_gaps(device, host, first, last)),
    )


def mapped(tree, fn):
    """``tree`` (tensors in lists, dataclasses, named tuples and dicts) with
    ``fn`` of each tensor in its place, taken in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [mapped(v, fn) for v in tree]
    if isinstance(tree, dict):
        return {k: mapped(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(mapped(v, fn) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: mapped(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    return tree


def to_host(tree):
    """``tree`` with its tensors copied to the host bit for bit, by one copy
    a dtype of their values laid end to end (a tensor given twice, once)."""
    leaves = {}
    mapped(tree, lambda t: leaves.setdefault(id(t), t))
    host = {}
    for dtype in {t.dtype for t in leaves.values()}:
        group = [t for t in leaves.values() if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group]).to(HOST)
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            host[id(t)] = piece.view(t.shape)
    return mapped(tree, lambda t: host[id(t)])


def relative(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| / |want| over the entries, in float64: 0
    where the two are equal (NaN on both sides included), the largest
    float64 where ``want`` is an exact zero and ``got`` is not, or one side
    only is NaN."""
    a, b = got.double(), want.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    rel = torch.where(same, 0.0, (a - b).abs() / b.abs())
    rel = torch.nan_to_num(rel, nan=float("inf"))
    return float(rel.max()) if rel.numel() else 0.0


def _program_state(s) -> ref.State:
    return ref.State(*(getattr(s, f).float() if getattr(s, f).is_floating_point()
                       else getattr(s, f) for f in ref.State._fields))


def _state_err(got: ref.State, want: ref.State, fields=ref.State._fields) -> float:
    return max(relative(getattr(got, f), getattr(want, f)) for f in fields)


def compare(config: Dict, seed: int, batch: int, start, samples: List[Sample]) -> Dict:
    """The numbers of the comparison of the program's ``start`` (its state
    after ``reset``) and ``samples`` with the reference, for the run seed
    ``seed``, and how many steps and rows it covered. The reference runs on
    ``start``'s device, each sample copied back there."""
    device = start.positions.device
    env = ref.make_env(config, pin_seed(seed), device)
    numbers = dict.fromkeys(NUMBERS, 0.0)
    with torch.no_grad():
        numbers["state_err"] = _state_err(_program_state(start),
                                          ref.reset(env, subseed(seed, ENV_STREAM), batch, device))
        for x in samples:
            x = mapped(x, lambda t: t.to(device))
            want = ref.step(env, _program_state(x.state), x.action, x.state.seed,
                            x.state.counter)
            got = _program_state(x.state_out)
            nxt = want.next_state
            flags = torch.stack([x.ts.terminated, x.ts.truncated], dim=-1)
            want_flags = torch.stack([want.terminated, want.truncated], dim=-1)
            counter = float(x.state_out.counter != x.state.counter + 1)
            numbers["position_err"] = max(numbers["position_err"],
                                          relative(got.positions, nxt.positions))
            numbers["velocity_err"] = max(numbers["velocity_err"],
                                          relative(got.velocities, nxt.velocities))
            numbers["obs_err"] = max(numbers["obs_err"], relative(x.ts.obs, want.obs),
                                     relative(x.ts.info["final_observation"], want.final_obs))
            numbers["reward_err"] = max(numbers["reward_err"], relative(x.ts.reward, want.reward))
            numbers["state_err"] = max(
                numbers["state_err"], relative(flags, want_flags), counter,
                _state_err(got, nxt, ("step", "total_energy", "episode_return")))
    return dict(numbers=numbers, steps=len(samples), rows=len(samples) * batch)


def check_run(ctx, start, samples: List[Sample]) -> Dict:
    """The numbers of the comparison, and how many steps and rows it
    covered."""
    return compare(ctx.config, ctx.seed, ctx.workload["batch"], start, samples)
