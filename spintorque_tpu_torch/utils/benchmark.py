"""Steady-state throughput of the vectorized env step and of the PPO train
step.

PyTorch counterpart of ``spintorque_tpu/utils/benchmark.py``.
``measure_env_throughput`` runs programs of ``n_inner`` eager env steps (16
is the PPO rollout length) with random actions, warms up, then times
``blocks`` blocks of ``iters_per_block`` programs with one device
synchronize per block, on the env's own device. ``measure_train_throughput``
times ``PPOTrainer`` train steps and splits each into its rollout and update
phases.

On a mesh (an env built with ``mesh=``) every rank runs the same program on
its rows; the ranks start each timed block together, and a rate is the
global env-steps over the slowest rank's time (``all_reduce(MAX)``). An
env whose batch the mesh replicates raises, as the JAX program's
``shard_batch`` does (``spintorque_tpu/utils/benchmark.py:86``).

``PEAK_FLOPS``, ``PEAK_FP32_INSTR``, ``PEAK_BF16_INSTR`` and
``PEAK_BYTES`` are the card's peaks that bounds and utilizations are priced
at.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..parallel.mesh import all_reduce

# The card's peaks (NVIDIA's data sheet, H100 SXM at its 700 W limit), the
# one copy that chip_smoke.py's bounds and scripts/torch/bench_roofline.py
# read.
PEAK_FLOPS = 67e12  # float32, outside the tensor cores (an FMA is two flops)
# Float32 instructions (FADD, FMUL, FFMA alike) issue one per lane per
# clock: 132 SMs x 128 lanes x 1.98 GHz, half the FMA flop rate. The
# kernels are built with --fmad=false, so an add or a multiply is one
# instruction: the rate every bound prices operations at.
PEAK_FP32_INSTR = PEAK_FLOPS / 2
# bf16 adds and multiplies outside the tensor cores: 133.8 TFLOP/s, twice
# the float32 rate, since one instruction works on a pair of bf16 values
# (HADD2/HMUL2 on .bf16x2). K6's native bf16 stage ops are priced at it.
PEAK_BF16_INSTR = 2 * PEAK_FP32_INSTR
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def _run_info(mesh, device) -> dict:
    """World size, process-group backend and device name of a measurement."""
    return dict(
        world_size=mesh.shape["data"] * mesh.shape["model"] if mesh is not None else 1,
        backend=mesh.backend if mesh is not None else None,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    )


def _slowest(seconds: float, mesh, device) -> float:
    """The largest of every rank's ``seconds``."""
    if mesh is None:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    return float(all_reduce(t, mesh, dist.ReduceOp.MAX)[0])


def _start_together(mesh, device, sync) -> None:
    """Wait until every rank's device is idle and every rank is here."""
    sync()
    if mesh is not None:
        all_reduce(torch.zeros(1, device=device), mesh)
        sync()


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
    generator lives on the env's device, and ``batch_size`` is the rank's
    rows. ``sync_debug_mode`` (CUDA only), when set, runs every timed
    block's steps under ``torch.cuda.set_sync_debug_mode`` ("error" makes
    any host sync of the step raise); the block's closing synchronize runs
    outside it.

    Returns (rates, env_steps_per_block), plus the final obs when
    ``return_final``; ``rates`` holds one env-steps/s number per block, of
    the global batch.
    """
    from ..parallel import random_policy

    if getattr(env, "replicated", False):
        raise ValueError(
            f"measure_env_throughput on a mesh needs a global batch that divides the data "
            f"axis, not {env.batch_size} over {env.mesh.shape['data']}: the JAX program's "
            "shard_batch of the observations raises too (spintorque_tpu/utils/benchmark.py:86)")
    cuda = env.device.type == "cuda"
    if sync_debug_mode is not None and not cuda:
        raise ValueError("sync_debug_mode needs an env on a CUDA device")
    if make_action is None:
        policy = random_policy(env)

        def act(generator, obs):
            return policy(None, obs, generator)
    else:
        def act(generator, obs):
            return make_action(generator, env.local_batch_size)

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
    steps_per_block = iters_per_block * n_inner * env.batch_size
    rates = []
    for _ in range(blocks):
        _start_together(env.mesh, env.device, sync)
        t0 = time.perf_counter()
        if sync_debug_mode is not None:
            torch.cuda.set_sync_debug_mode(sync_debug_mode)
        try:
            run(iters_per_block)
        finally:
            if sync_debug_mode is not None:
                torch.cuda.set_sync_debug_mode("default")
        sync()
        rates.append(steps_per_block / _slowest(time.perf_counter() - t0, env.mesh, env.device))
    if return_final:
        return rates, steps_per_block, obs
    return rates, steps_per_block


def measure_train_throughput(trainer, *, warmup: int = 1, steps: int = 3, seed: int = 0,
                             sync_debug_mode=None):
    """Train env-steps/s of ``trainer`` (a ``PPOTrainer``) in steady state.

    Runs ``warmup`` train steps, then times ``steps`` train steps, each its
    rollout (``trainer.collect``) then its update (``trainer.update``), the
    two phases of ``trainer.train_step``. A step's env-steps are
    ``rollout_steps * batch_size``. On CUDA the phases are timed by CUDA
    events and the step by the host clock up to a synchronize that ends it;
    eager phases run back to back on one stream, so the two add up to the
    step's device time, and a phase whose launches the host issues slower
    than the device runs them includes the device's wait for the host. On
    the CPU everything is the host clock.
    ``sync_debug_mode`` (CUDA only), when set, runs the timed steps under
    ``torch.cuda.set_sync_debug_mode``; each step's closing synchronize runs
    outside it.

    Returns a dict: ``device`` (the card's name, or "cpu"), ``world_size``
    and ``backend`` (of the trainer's mesh; 1 and None without one),
    ``rates`` (global env-steps/s per timed step, over the slowest rank's
    time), ``env_steps_per_step``, ``rollout_ms`` and ``update_ms`` (this
    rank's, per timed step), ``metrics`` (the last step's, as floats) and
    ``state`` (the final TrainState).
    """
    env = trainer.env
    cuda = env.device.type == "cuda"
    if sync_debug_mode is not None and not cuda:
        raise ValueError("sync_debug_mode needs an env on a CUDA device")
    ts = trainer.init(seed)
    for _ in range(warmup):
        ts, _ = trainer.train_step(ts)
    env_steps = trainer.config.rollout_steps * env.batch_size
    out = dict(
        **_run_info(trainer.mesh, env.device),
        rates=[], env_steps_per_step=env_steps, rollout_ms=[], update_ms=[],
    )

    def sync():
        if cuda:
            torch.cuda.synchronize(env.device)

    metrics = {}
    for _ in range(steps):
        _start_together(trainer.mesh, env.device, sync)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        t0 = time.perf_counter()
        if sync_debug_mode is not None:
            torch.cuda.set_sync_debug_mode(sync_debug_mode)
        try:
            if cuda:
                marks[0].record()
            ts, traj = trainer.collect(ts)
            if cuda:
                marks[1].record()
            t1 = time.perf_counter()
            metrics = trainer.update(ts, traj)
            ts = dataclasses.replace(ts, update_count=ts.update_count + 1)
            if cuda:
                marks[2].record()
        finally:
            if sync_debug_mode is not None:
                torch.cuda.set_sync_debug_mode("default")
        sync()
        t2 = time.perf_counter()
        out["rates"].append(env_steps / _slowest(t2 - t0, trainer.mesh, env.device))
        if cuda:
            out["rollout_ms"].append(marks[0].elapsed_time(marks[1]))
            out["update_ms"].append(marks[1].elapsed_time(marks[2]))
        else:
            out["rollout_ms"].append((t1 - t0) * 1e3)
            out["update_ms"].append((t2 - t1) * 1e3)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["state"] = ts
    return out
