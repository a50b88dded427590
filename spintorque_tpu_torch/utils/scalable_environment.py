"""Managed vectorized-environment execution with autoscaling.

PyTorch counterpart of ``spintorque_tpu/utils/scalable_environment.py``.
One vectorized env is the pool of envs; the manager picks and adjusts its
batch size (``utils/scaling.AutoScaler``), runs steady-state chunks of
steps and reports their throughput.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .scaling import AutoScaler

__all__ = ["ScalableEnvironmentManager"]


class ScalableEnvironmentManager:
    """Run batched episodes at an autoscaled batch size.

    env_factory(batch_size) must return a vectorized env with the
    functional API (reset(seed) -> (state, obs); step(state, action) ->
    (state, ts)), on the device the caller chose for it.
    """

    def __init__(
        self,
        env_factory: Callable[[int], Any],
        initial_batch: int = 1024,
        min_batch: int = 128,
        max_batch: int = 65536,
        autoscale: bool = True,
    ):
        self.env_factory = env_factory
        self.autoscaler = AutoScaler(
            initial_batch=initial_batch, min_batch=min_batch, max_batch=max_batch,
            cooldown_s=0.0,
        )
        self.autoscale = autoscale
        self._envs: Dict[int, Any] = {}
        self._policy_cache: Dict[int, Any] = {}
        self.history: List[Dict[str, float]] = []

    def _env(self, batch: int) -> Any:
        if batch not in self._envs:
            self._envs[batch] = self.env_factory(batch)
        return self._envs[batch]

    def run_batch_steps(
        self,
        n_steps: int,
        policy: Optional[Callable] = None,
        seed: int = 0,
        batch: Optional[int] = None,
    ) -> Dict[str, float]:
        """One measured chunk of ``n_steps`` vectorized env steps, after
        one warm-up step; the env resets from ``seed`` and the policy draws
        from a generator on the env's device seeded from it."""
        from ..ops.philox import derive_seed

        batch = batch or self.autoscaler.batch
        env = self._env(batch)
        if policy is None:
            from ..parallel.rollout import random_policy

            policy = self._policy_cache.setdefault(batch, random_policy(env))
        state, obs = env.reset(seed)
        generator = torch.Generator(device=env.device)
        generator.manual_seed(derive_seed(seed, 1))

        def sync():
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)

        # warm-up step outside the measurement
        state, ts = env.step(state, policy(None, obs, generator))
        sync()

        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, ts = env.step(state, policy(None, ts.obs, generator))
        sync()
        elapsed = time.perf_counter() - t0

        self.autoscaler.record(batch, n_steps, elapsed)
        if self.autoscale:
            self.autoscaler.recommend()
        chunk = {
            "batch": batch,
            "steps": n_steps,
            "elapsed_s": elapsed,
            "env_steps_per_s": batch * n_steps / max(elapsed, 1e-9),
            "mean_reward": float(ts.reward.mean()),
        }
        self.history.append(chunk)
        return chunk

    def run_until_stable(
        self, chunks: int = 4, n_steps: int = 16, seed: int = 0
    ) -> Dict[str, Any]:
        """Repeatedly run/measure/rescale; returns the best configuration."""
        for c in range(chunks):
            self.run_batch_steps(n_steps, seed=seed + c)
        stats = self.autoscaler.get_statistics()
        by_batch = stats["throughput_by_batch"]
        best_batch = max(by_batch, key=by_batch.get)
        return {
            "best_batch": int(best_batch),
            "best_env_steps_per_s": by_batch[best_batch],
            "measured": by_batch,
            "chunks": list(self.history),
        }

    def get_statistics(self) -> Dict[str, Any]:
        return {
            "autoscaler": self.autoscaler.get_statistics(),
            "n_envs_instantiated": len(self._envs),
            "chunks_run": len(self.history),
        }
