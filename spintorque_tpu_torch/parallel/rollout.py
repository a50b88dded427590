"""Rollout collection.

PyTorch counterpart of ``spintorque_tpu/parallel/rollout.py``: a Python loop
over ``env.step`` in place of the jitted ``lax.scan``. Policy forward and env
transition stay on the env's device for the whole horizon; nothing is read
back until the caller reads the trajectory or its summary.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..envs.spin_torque import EnvState, SpinTorqueEnv

Tensor = torch.Tensor


class Trajectory(NamedTuple):
    obs: Any  # (T, B, obs_dim)
    action: Any  # (T, B, act_dim) or (T, B)
    reward: Any  # (T, B)
    terminated: Any  # (T, B)
    truncated: Any  # (T, B)
    log_prob: Any  # (T, B) (zeros when the policy provides none)
    value: Any  # (T, B) (zeros when the policy provides none)
    info: Dict[str, Any]  # selected per-step metrics, each (T, B)


_INFO_KEYS = ("is_success", "step_energy", "current_alignment", "episode_return")


@torch.no_grad()
def rollout(
    env: SpinTorqueEnv,
    policy_fn: Callable,
    policy_params: Any,
    state: EnvState,
    obs: Any,
    generator: torch.Generator,
    num_steps: int,
) -> Tuple[EnvState, Any, Trajectory]:
    """Collect ``num_steps`` transitions on the env's device.

    policy_fn(params, obs, generator) must return either
      actions                       - plain actors, random policies
      (actions, log_prob, value)    - actor-critic (PPO) policies
    ``generator`` lives on the env's device.
    """
    records = []
    for _ in range(num_steps):
        out = policy_fn(policy_params, obs, generator)
        if isinstance(out, tuple):
            action, log_prob, value = out
        else:
            action, log_prob, value = out, None, None
        state, ts = env.step(state, action)
        zeros = torch.zeros_like(ts.reward)
        records.append(Trajectory(
            obs=obs,
            action=action,
            reward=ts.reward,
            terminated=ts.terminated,
            truncated=ts.truncated,
            log_prob=zeros if log_prob is None else log_prob,
            value=zeros if value is None else value,
            info={k: ts.info[k] for k in _INFO_KEYS},
        ))
        obs = ts.obs
    traj = Trajectory(
        *(torch.stack([getattr(r, f) for r in records]) for f in Trajectory._fields[:-1]),
        info={k: torch.stack([r.info[k] for r in records]) for k in _INFO_KEYS},
    )
    return state, obs, traj


def summarize(traj: Trajectory) -> Dict[str, Any]:
    """Scalar rollout metrics: ``steps`` a host int, the rest 0-dim device
    tensors."""
    done = traj.terminated | traj.truncated
    n_done = done.sum()
    episodes = torch.clamp_min(n_done, 1)
    return {
        "steps": traj.reward.numel(),
        "mean_reward": traj.reward.mean(),
        "episodes": n_done,
        "success_rate": torch.where(
            done.any(), (traj.terminated & done).sum() / episodes, 0.0
        ),
        "mean_step_energy": traj.info["step_energy"].mean(),
        "mean_alignment": traj.info["current_alignment"].mean(),
    }


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
