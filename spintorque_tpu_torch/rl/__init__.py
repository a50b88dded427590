"""RL training: the PPO trainer and its actor-critic networks.

PyTorch counterpart of ``spintorque_tpu/rl``.
"""

from .networks import (
    ActorCritic,
    continuous_action_transform,
    gaussian_log_prob,
    sample_continuous,
)
from .ppo import PPOConfig, PPOTrainer, TrainState

__all__ = [
    "ActorCritic",
    "continuous_action_transform",
    "gaussian_log_prob",
    "sample_continuous",
    "PPOConfig",
    "PPOTrainer",
    "TrainState",
]
