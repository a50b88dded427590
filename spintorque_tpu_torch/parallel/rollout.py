"""Rollout helpers.

PyTorch counterpart of ``spintorque_tpu/parallel/rollout.py``; only the
random policy that drives the throughput measurement is ported so far.
"""

from __future__ import annotations

import torch

from ..envs.spin_torque import SpinTorqueEnv


def random_policy(env: SpinTorqueEnv):
    """Uniform random policy over the env's action space.

    Returns ``policy(params, obs, generator)``; ``generator`` is a
    torch.Generator on the env's device, so drawing reads nothing back."""
    cfg = env.config

    def policy(params, obs, generator):
        del params
        B = obs.shape[0] if not isinstance(obs, dict) else next(iter(obs.values())).shape[0]
        if cfg.action_mode == "continuous":
            u = torch.rand((2, B), generator=generator, dtype=cfg.torch_dtype, device=env.device)
            current = -cfg.max_current + (2.0 * cfg.max_current) * u[0]
            duration = 1e-12 + (cfg.max_duration - 1e-12) * u[1]
            return torch.stack([current, duration], dim=-1)
        return torch.randint(0, env.num_actions, (B,), generator=generator, device=env.device)

    return policy
