"""Steady-state throughput of the vectorized env step.

PyTorch counterpart of ``spintorque_tpu/utils/benchmark.py``: the one
measurement program of the port. It runs programs of ``n_inner`` eager env
steps (16 is the PPO rollout length) with random actions, warms up, then
times ``blocks`` blocks of ``iters_per_block`` programs with one device
synchronize per block, on the env's own device.
"""

from __future__ import annotations

import time

import torch


def measure_env_throughput(
    env,
    *,
    n_inner: int = 16,
    warmup: int = 12,
    blocks: int = 1,
    iters_per_block: int = 8,
    seed: int = 0,
    make_action=None,
    return_final: bool = False,
    sync_debug_mode=None,
):
    """Env-steps/s of ``env.step`` in steady state.

    ``make_action(generator, batch_size)`` overrides the random policy; the
    generator lives on the env's device. ``sync_debug_mode`` (CUDA only),
    when set, runs every timed block's steps under
    ``torch.cuda.set_sync_debug_mode`` ("error" makes any host sync of the
    step raise); the block's closing synchronize runs outside it.

    Returns (rates, env_steps_per_block), plus the final obs when
    ``return_final``; ``rates`` holds one env-steps/s number per block.
    """
    from ..parallel import random_policy

    cuda = env.device.type == "cuda"
    if sync_debug_mode is not None and not cuda:
        raise ValueError("sync_debug_mode needs an env on a CUDA device")
    if make_action is None:
        policy = random_policy(env)

        def act(generator, obs):
            return policy(None, obs, generator)
    else:
        def act(generator, obs):
            return make_action(generator, env.batch_size)

    state, obs = env.reset(seed)
    generator = torch.Generator(device=env.device)
    generator.manual_seed(seed + 1)

    def sync():
        if cuda:
            torch.cuda.synchronize(env.device)

    def run(programs):
        nonlocal state, obs
        for _ in range(programs):
            for _ in range(n_inner):
                state, ts = env.step(state, act(generator, obs))
                obs = ts.obs

    run(warmup)
    sync()
    steps_per_block = iters_per_block * n_inner * env.batch_size
    rates = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        if sync_debug_mode is not None:
            torch.cuda.set_sync_debug_mode(sync_debug_mode)
        try:
            run(iters_per_block)
        finally:
            if sync_debug_mode is not None:
                torch.cuda.set_sync_debug_mode("default")
        sync()
        rates.append(steps_per_block / (time.perf_counter() - t0))
    if return_final:
        return rates, steps_per_block, obs
    return rates, steps_per_block
