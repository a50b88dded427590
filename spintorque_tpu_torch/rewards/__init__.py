"""Reward system: batched components + composite aggregation.

PyTorch counterpart of ``spintorque_tpu/rewards``.
"""

from .components import (
    DEFAULT_REWARD_CONFIG,
    ENERGY_OPTIMIZED_CONFIG,
    REGISTRY,
    SPEED_OPTIMIZED_CONFIG,
    RewardContext,
    alignment_reward,
    default_reward_config,
    energy_penalty,
    progress_reward,
    resolve,
    speed_reward,
    stability_penalty_dict,
    stability_penalty_vector,
    success_reward,
)
from .composite import CompositeReward, RunningStat

__all__ = [
    "DEFAULT_REWARD_CONFIG",
    "ENERGY_OPTIMIZED_CONFIG",
    "SPEED_OPTIMIZED_CONFIG",
    "REGISTRY",
    "RewardContext",
    "default_reward_config",
    "alignment_reward",
    "energy_penalty",
    "progress_reward",
    "resolve",
    "speed_reward",
    "stability_penalty_dict",
    "stability_penalty_vector",
    "success_reward",
    "CompositeReward",
    "RunningStat",
]
