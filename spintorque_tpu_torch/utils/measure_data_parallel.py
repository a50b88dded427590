"""Data-parallel throughput of the env step and the PPO train step, one
process per card, with the cost of the trainer's collectives.

    torchrun --standalone --nproc_per_node N -m spintorque_tpu_torch.utils.measure_data_parallel [--out FILE]

Every rank joins the process group, N = 1 included (one NCCL rank then runs
the same collectives as N ranks do), holds 4096 envs of the default config
(the global batch grows with the world size, so it always divides the
ranks: ``utils.benchmark`` and the trainer raise on one that does not, as
the JAX package's do) and runs the two measurement
programs of ``utils.benchmark`` on its rows: env-steps/s over 16-step
programs, then PPO train steps with the default ``PPOConfig``. A rate is
the global env-steps over the slowest rank's time. Beside the mesh trainer,
each rank times a trainer without a mesh on 4096 envs of its own (no
collective), then profiles one update of each with ``torch.profiler``: the
wall time, the device's busy time and the host ops that take the most self
time, so that the two updates can be told apart op by op. Both the timings
and the profiles run in the order mesh, plain, plain, mesh, so that a drift
over the run falls on both alike; the profiles come last, since a profiler
session slows the host in what follows it.

The script checks that each rank launched the sharded pulse kernel (K5)
once per env step, and that every rank ends the train steps with the same
parameters; any failure raises on its rank, and torchrun fails the job.
Rank 0 prints one JSON line with the world size, backend, card, rates and
profiles (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..envs import SpinTorqueEnv
from ..ops import cuda_integrator as ci
from ..parallel import all_reduce, initialize, make_mesh
from ..rl import PPOConfig, PPOTrainer
from .benchmark import measure_env_throughput, measure_train_throughput
from .host import card_line

PER_RANK_BATCH = 4096
ENV_BLOCKS = 3
TRAIN_STEPS = 3


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def profile_update(trainer) -> dict:
    """One ``trainer.update`` on a fresh rollout under ``torch.profiler``:
    its wall time (ms, profiler on), the device's busy time (ms, the sum of
    the kernels' self device times) and the 12 host ops of most self CPU
    time as [name, calls, ms]."""
    ts = trainer.init(1)
    ts, traj = trainer.collect(ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.update(ts, traj)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    return dict(wall_ms=wall_ms, device_busy_ms=device_us / 1e3,
                host_ops=[[e.key, e.count, e.self_cpu_time_total / 1e3] for e in host])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    initialize(init_method="env://")
    mesh = make_mesh()
    world = mesh.shape["data"]

    def env():
        return SpinTorqueEnv(batch_size=PER_RANK_BATCH * world, mesh=mesh)

    ci.PULSE_SHARDED_LAUNCHES.reset()
    rates, _ = measure_env_throughput(env(), n_inner=16, warmup=2, blocks=ENV_BLOCKS,
                                      iters_per_block=2)
    env_launches = ci.PULSE_SHARDED_LAUNCHES.count
    trainers = dict(mesh=PPOTrainer(env(), PPOConfig()),
                    plain=PPOTrainer(SpinTorqueEnv(batch_size=PER_RANK_BATCH), PPOConfig()))
    order = ("mesh", "plain", "plain", "mesh")
    runs = {"mesh": [], "plain": []}
    ci.PULSE_SHARDED_LAUNCHES.reset()
    for name in order:
        runs[name].append(measure_train_throughput(trainers[name], warmup=1, steps=TRAIN_STEPS))
    train_launches = ci.PULSE_SHARDED_LAUNCHES.count
    want = (16 * (2 + 2 * ENV_BLOCKS), 2 * 16 * (1 + TRAIN_STEPS))
    if (env_launches, train_launches) != want:
        raise RuntimeError(f"K5 launched {env_launches} / {train_launches} times, want {want}")
    out = runs["mesh"][-1]
    params = torch.cat([p.detach().reshape(-1) for p in out["state"].network.parameters()])
    root = params.clone()
    dist.broadcast(root, src=0, group=mesh.data_group)
    same = torch.tensor([float(torch.equal(params, root))], device=mesh.device)
    if float(all_reduce(same, mesh, dist.ReduceOp.MIN)[0]) != 1.0:
        raise RuntimeError("the ranks hold different parameters after the train steps")

    profiles = {"mesh": [], "plain": []}
    for name in order:
        profiles[name].append(profile_update(trainers[name]))

    def joined(name, key):
        return [x for run in runs[name] for x in run[key]]

    result = dict(
        world_size=out["world_size"], backend=mesh.backend, device=out["device"],
        per_rank_batch=PER_RANK_BATCH, global_batch=PER_RANK_BATCH * world,
        env_steps_per_s=_median(rates), env_rates=rates,
        train_env_steps_per_s=_median(joined("mesh", "rates")), train_rates=joined("mesh", "rates"),
        rollout_ms=joined("mesh", "rollout_ms"), update_ms=joined("mesh", "update_ms"),
        plain_train_rates=joined("plain", "rates"), plain_rollout_ms=joined("plain", "rollout_ms"),
        plain_update_ms=joined("plain", "update_ms"), update_profiles=profiles,
        k5_launches=dict(env=env_launches, train=train_launches),
        metrics=out["metrics"],
        card=card_line(),
    )
    if mesh.data_rank == 0:
        line = json.dumps(result)
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
