"""Reward component library.

PyTorch counterpart of ``spintorque_tpu/rewards/components.py``: plain
batched functions mapping a RewardContext to a (B,) tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass(frozen=True)
class RewardContext:
    """Batched per-step quantities reward components can consume."""

    is_success: Any  # (B,) bool
    step_energy: Any  # (B,) J
    alignment: Any  # (B,) m . target after the step
    alignment_improvement: Any  # (B,)
    magnetization_norm: Any  # (B,) |m| after the step
    step_count: Any  # (B,) int32 (post-increment)
    total_energy: Any  # (B,) J
    action_current: Any  # (B,) A/m^2
    action_duration: Any  # (B,) s
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


RewardFn = Callable[[RewardContext], Any]


def success_reward(ctx: RewardContext):
    """10 on success else 0."""
    return torch.where(ctx.is_success, 10.0, 0.0).to(ctx.alignment.dtype)


def alignment_reward(ctx: RewardContext):
    return ctx.alignment


def energy_penalty(ctx: RewardContext):
    """-E/pJ."""
    return -ctx.step_energy / 1e-12


def progress_reward(ctx: RewardContext):
    return ctx.alignment_improvement


def stability_penalty_dict(ctx: RewardContext):
    """-max(0, |m| - 1.1): the dict-observation stability term."""
    return -torch.clamp_min(ctx.magnetization_norm - 1.1, 0.0)


def stability_penalty_vector(ctx: RewardContext):
    """The reference env's default 'stability' component is 0 for vector
    observations; kept as it is."""
    return torch.zeros_like(ctx.alignment)


def speed_reward(ctx: RewardContext):
    """1 / (1 + 0.1 step)."""
    return 1.0 / (1.0 + ctx.step_count.to(ctx.alignment.dtype) * 0.1)


REGISTRY: Dict[str, RewardFn] = {
    "success": success_reward,
    "alignment": alignment_reward,
    "energy": energy_penalty,
    "progress": progress_reward,
    "stability": stability_penalty_vector,
    "stability_dict": stability_penalty_dict,
    "speed": speed_reward,
}


def resolve(fn_or_name: RewardFn | str) -> RewardFn:
    if callable(fn_or_name):
        return fn_or_name
    if fn_or_name in REGISTRY:
        return REGISTRY[fn_or_name]
    raise KeyError(f"Unknown reward component '{fn_or_name}'. Known: {sorted(REGISTRY)}")


def default_reward_config(energy_penalty_weight: float = 0.1,
                          observation_mode: str = "vector") -> Dict[str, Dict]:
    """The main env's default composite config.

    Quirk kept from the reference: weight=-energy_penalty_weight pairs with a
    component that already returns -E/pJ, so the net energy term is positive.
    """
    stability = "stability_dict" if observation_mode == "dict" else "stability"
    return {
        "success": {"weight": 10.0, "function": "success"},
        "energy": {"weight": -energy_penalty_weight, "function": "energy"},
        "progress": {"weight": 1.0, "function": "progress"},
        "stability": {"weight": -2.0, "function": stability},
    }


# Canned configurations.
DEFAULT_REWARD_CONFIG = {
    "success": {"weight": 10.0, "function": "success"},
    "energy": {"weight": -0.1, "function": "energy"},
    "progress": {"weight": 1.0, "function": "progress"},
    "stability": {"weight": -2.0, "function": "stability_dict"},
}

ENERGY_OPTIMIZED_CONFIG = {
    "success": {"weight": 5.0, "function": "success"},
    "energy": {"weight": -1.0, "function": "energy",
               "normalize": {"mean": 0.0, "std": 1e-12}},
    "alignment": {"weight": 2.0, "function": "alignment"},
}

SPEED_OPTIMIZED_CONFIG = {
    "success": {"weight": 10.0, "function": "success"},
    "speed": {"weight": 5.0, "function": "speed"},
    "progress": {"weight": 2.0, "function": "progress"},
}
