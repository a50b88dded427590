"""Driver ``rollout``: a vectorized env stepped in programs of eager steps,
actions drawn on the card, the host waiting for the card only at the end of
each block of programs to read the clock (a closed loop with the policy on
the card).

Workload keys: ``batch``, ``program_steps``, ``block_programs``,
``warmup_programs``, ``trace_programs`` and ``traffic`` (source ``card``).

Records: ``setup_s``; ``window`` (its ``seconds``, ``steps`` and
``env_steps``); with the trace on, ``trace`` (see ``lib/profile.py``).
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from perfbench.lib import check, profile, program
from perfbench.lib.traffic import Actions


def run(ctx):
    wl = ctx.workload
    batch, steps = wl["batch"], wl["program_steps"]
    env = program.make_env(ctx.config, batch, ctx.device, control=ctx.control)
    if ctx.patch is not None:
        ctx.patch(env)
    actions = Actions(wl["traffic"], batch, ctx.seed, ctx.device)
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
                kept.append(check.Sample(state, action, nxt, ts))
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
        box = [state]

        def traced():
            action = actions()
            with record_function("env.step"):
                box[0], _ = env.step(box[0], action)
            return action[:, 1]

        records["trace"] = profile.profiled(ctx, traced, wl["trace_programs"] * steps)
    return records, start, kept
