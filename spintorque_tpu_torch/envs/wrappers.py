"""Gymnasium environment wrappers.

PyTorch counterpart of ``spintorque_tpu/envs/wrappers.py``: retries,
sanitized outputs and fallback results around reset/step. The env step
already clamps and NaN-guards on the device, so the wrapper's jobs are
host-side input sanitization, failure accounting and fallback responses
for adapter-level errors (bad action shapes, a lost device).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

try:
    import gymnasium as gym
except ImportError as e:  # pragma: no cover
    raise ImportError("gymnasium is required for env wrappers") from e

from ..utils.monitoring import EnvironmentMonitor, SafetyWrapper


class RobustEnvironmentWrapper(gym.Wrapper):
    """Retry and sanitize wrapper."""

    def __init__(
        self,
        env: gym.Env,
        max_retries: int = 2,
        fallback_reward: float = -1.0,
        monitor: Optional[EnvironmentMonitor] = None,
    ):
        super().__init__(env)
        self.max_retries = max_retries
        self.fallback_reward = fallback_reward
        self.monitor = monitor or EnvironmentMonitor()
        self.safety = SafetyWrapper(self.monitor)
        self.stats = {
            "resets": 0, "steps": 0, "reset_failures": 0, "step_failures": 0,
            "fallbacks_used": 0,
        }
        self._last_obs = None

    def reset(self, **kwargs):
        self.stats["resets"] += 1
        last_err = None
        for attempt in range(self.max_retries + 1):
            try:
                obs, info = self.env.reset(**kwargs)
                self._last_obs = obs
                return self._sanitize_obs(obs), info
            except Exception as e:  # noqa: BLE001
                last_err = e
                self.stats["reset_failures"] += 1
                self.monitor.log_error(e, "reset")
                time.sleep(0.01 * (attempt + 1))
        raise RuntimeError(f"reset failed after retries: {last_err}")

    def step(self, action):
        self.stats["steps"] += 1
        try:
            if isinstance(action, np.ndarray) and action.shape == (2,):
                action = self.safety.validate_action(action)
            obs, reward, terminated, truncated, info = self.env.step(action)
            obs = self._sanitize_obs(obs)
            reward = self.safety.validate_reward(reward)
            self._last_obs = obs
            return obs, reward, terminated, truncated, info
        except Exception as e:  # noqa: BLE001
            # Fallback step result: penalty reward, truncate, reuse the last
            # observation.
            self.stats["step_failures"] += 1
            self.stats["fallbacks_used"] += 1
            self.monitor.log_error(e, "step")
            obs = self._last_obs
            if obs is None:
                obs = self.observation_space.sample() * 0
            return obs, self.fallback_reward, False, True, {"error": str(e)}

    def _sanitize_obs(self, obs):
        if isinstance(obs, dict):
            return {k: self.safety.validate_observation(v) for k, v in obs.items()}
        return self.safety.validate_observation(obs)

    def get_stats(self) -> Dict[str, Any]:
        return dict(self.stats)


class EpisodeStatisticsWrapper(gym.Wrapper):
    """Lightweight episode return/length tracking for host loops."""

    def __init__(self, env: gym.Env):
        super().__init__(env)
        self.episode_return = 0.0
        self.episode_length = 0
        self.history: list = []

    def reset(self, **kwargs):
        if self.episode_length:
            self.history.append(
                {"return": self.episode_return, "length": self.episode_length}
            )
        self.episode_return = 0.0
        self.episode_length = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.episode_return += float(reward)
        self.episode_length += 1
        if terminated or truncated:
            info = dict(info)
            info["episode"] = {
                "r": self.episode_return, "l": self.episode_length,
            }
        return obs, reward, terminated, truncated, info
