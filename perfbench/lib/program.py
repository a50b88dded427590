"""The system under test: ``spintorque_tpu_torch``, and nothing else of the
repository. The one module of the benchmark that imports it."""

from __future__ import annotations

from typing import Dict

import numpy as np


def join_ranks(rank: int, world: int, url: str, backend=None) -> None:
    """This process joins the process group as ``rank`` of ``world``
    through the port's ``parallel.initialize`` (NCCL with cards, each rank
    on its own)."""
    from spintorque_tpu_torch.parallel import initialize

    initialize(init_method=url, world_size=world, rank=rank, backend=backend)


def leave_ranks() -> None:
    """Leaves the process group, where this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(device):
    """The port's data mesh over every rank of the process group."""
    from spintorque_tpu_torch.parallel import make_mesh as mesh

    return mesh(device=device.type)


def make_env(config: Dict, batch: int, device, *, control: bool = False, mesh=None):
    """The port's ``SpinTorqueEnv`` for a configuration file, with the
    configuration's device parameters and targets handed to it; ``batch``
    is the global batch, of which a ``mesh`` gives this rank its rows.
    ``control`` switches on the port's bf16 stage arithmetic (K6 on the
    card), the precision below the configuration's float32."""
    from spintorque_tpu_torch.envs.spin_torque import SpinTorqueEnv, SpinTorqueEnvConfig

    env_cfg = dict(config["env"])
    if control:
        env_cfg["bf16_rhs"] = True
    params = {k: (np.asarray(v) if isinstance(v, list) else v)
              for k, v in config["device_params"].items()}
    return SpinTorqueEnv(
        device_params=params,
        target_states=[np.asarray(t, float) for t in config["target_states"]],
        batch_size=batch,
        config=SpinTorqueEnvConfig(**env_cfg),
        device=None if mesh is not None else device,
        mesh=mesh,
    )


def make_trainer(env, ppo: Dict, *, control: bool = False):
    """The port's ``PPOTrainer`` with the workload's ``PPOConfig`` fields;
    ``control`` computes the network's layers in bfloat16, the precision
    below the configuration's float32."""
    from spintorque_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

    cfg = dict(ppo, hidden_sizes=tuple(ppo["hidden_sizes"]),
               compute_dtype="bfloat16" if control else "float32")
    return PPOTrainer(env, PPOConfig(**cfg))


def pulse_launches() -> int:
    """Launches of the pulse kernel so far, float32, bf16 and on a rank's
    shard (the port's own counters)."""
    from spintorque_tpu_torch.ops import cuda_integrator as ci

    return (ci.PULSE_LAUNCHES.count + ci.PULSE_BF16_LAUNCHES.count
            + ci.PULSE_SHARDED_LAUNCHES.count)


def to_host(tree):
    """The Gymnasium adapters' one read of a step's outputs."""
    from spintorque_tpu_torch.utils.host import to_host as read

    return read(tree)
