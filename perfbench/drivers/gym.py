"""Driver ``gym``: one env stepped one step at a time, as a Gymnasium agent
loop steps it: the agent's action is a host array, and every step ends
with the adapters' one read of obs, reward, terminated and truncated to
the host (a closed loop with one client). The env resets itself on the
device when an episode ends (auto-reset).

Workload keys: ``batch``, ``warmup_steps``, ``trace_steps`` and ``traffic``
(source ``host``).

Records: ``setup_s``; ``window`` (its ``seconds`` and ``steps``);
``step_ms`` (each step with its read, by the host clock); ``env_step_ms``
(the benchmark's span around ``env.step`` alone, until it returns); with
the trace on, ``trace`` (see ``lib/profile.py``).
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from perfbench.lib import check, profile, program
from perfbench.lib.traffic import Actions


def run(ctx):
    wl = ctx.workload
    batch = wl["batch"]
    env = program.make_env(ctx.config, batch, ctx.device, control=ctx.control)
    if ctx.patch is not None:
        ctx.patch(env)
    actions = Actions(wl["traffic"], batch, ctx.seed, ctx.device)
    state, _ = env.reset(ctx.env_seed)
    start = state

    def one(state, action):
        state, ts = env.step(state, action)
        program.to_host((ts.obs, ts.reward, ts.terminated, ts.truncated))
        return state, ts

    for _ in range(wl["warmup_steps"]):
        state, _ = one(state, actions())
    setup_s = time.time() - ctx.process_start

    kept, step_ms, env_step_ms = [], [], []
    clock = time.perf_counter
    t0 = clock()
    while True:
        action = actions()
        a = clock()
        nxt, ts = env.step(state, action)
        b = clock()
        program.to_host((ts.obs, ts.reward, ts.terminated, ts.truncated))
        c = clock()
        step_ms.append((c - a) * 1e3)
        env_step_ms.append((b - a) * 1e3)
        if ctx.sampled(len(step_ms) - 1):
            kept.append((state, action, nxt, ts))
        state = nxt
        if c - t0 >= ctx.seconds:
            break
    records = dict(
        setup_s=setup_s,
        window=dict(seconds=c - t0, steps=len(step_ms)),
        step_ms=step_ms,
        env_step_ms=env_step_ms,
        attempted=len(step_ms),
        failed=0,
        memory_peak_bytes=(torch.cuda.max_memory_allocated(ctx.device)
                           if ctx.device.type == "cuda" else 0),
    )
    if ctx.trace:
        box = [state]

        def traced():
            action = actions()
            with record_function("env.step"):
                box[0], ts = env.step(box[0], action)
            with record_function("host.read"):
                program.to_host((ts.obs, ts.reward, ts.terminated, ts.truncated))
            return action[:, 1]

        records["trace"] = profile.profiled(ctx, traced, wl["trace_steps"])
    samples = [check.Sample(s, torch.as_tensor(a, device=ctx.device), n, ts)
               for s, a, n, ts in kept]
    return records, start, samples
