"""Rollout collection.

PyTorch counterpart of ``spintorque_tpu/parallel/rollout.py``: a Python loop
over ``env.step`` in place of the jitted ``lax.scan``. Policy forward and env
transition stay on the env's device for the whole horizon; nothing is read
back until the caller reads the trajectory or its summary. On a mesh each
rank collects its own rows; ``summarize`` reduces over the ranks.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, NamedTuple, Tuple

import torch

from .mesh import all_reduce, split_mesh

if TYPE_CHECKING:  # envs imports parallel.mesh
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


def summarize(traj: Trajectory, env: SpinTorqueEnv | None = None) -> Dict[str, Any]:
    """Scalar rollout metrics: ``steps`` a host int, the rest 0-dim device
    tensors. ``env`` is the env ``traj`` was collected from: where its mesh
    splits the batch (``traj`` holds this rank's rows) they are global, one
    ``all_reduce(SUM)`` of the counts and sums, the same on every rank;
    where the mesh replicates it (``split_mesh``) every rank holds the whole
    batch and reduces nothing."""
    mesh = None if env is None else split_mesh(env.batch_size, env.mesh)
    done = traj.terminated | traj.truncated
    sums = all_reduce(torch.stack([
        x.sum().to(torch.float64) for x in (
            done, traj.terminated & done, traj.reward, traj.info["step_energy"],
            traj.info["current_alignment"],
        )
    ]), mesh)
    n_done, n_success, reward, energy, alignment = sums.unbind()
    dtype = traj.reward.dtype
    count = traj.reward.numel() * (mesh.shape["data"] if mesh is not None else 1)
    return {
        "steps": count,
        "mean_reward": (reward / count).to(dtype),
        "episodes": n_done.to(torch.int64),
        "success_rate": torch.where(
            n_done > 0, n_success / torch.clamp_min(n_done, 1), 0.0
        ).to(dtype),
        "mean_step_energy": (energy / count).to(dtype),
        "mean_alignment": (alignment / count).to(dtype),
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
