"""Environment monitoring, safety validation and health reporting.

PyTorch counterpart of ``spintorque_tpu/utils/monitoring.py`` (numpy and
the standard library, as there), for the host loop: aggregating per-step
metrics, logging, host-side pre-validation of actions with the reference's
clamp limits, and health reports. The env step itself clamps and
NaN-guards on the device.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger("spintorque_tpu_torch")


class MetricsCollector:
    """Rolling metric aggregation."""

    def __init__(self, window: int = 1000):
        self.window = window
        self._values: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._counters: Dict[str, int] = defaultdict(int)

    def record(self, name: str, value: float) -> None:
        self._values[name].append(float(value))

    def record_batch(self, name: str, values) -> None:
        arr = np.asarray(values).ravel()
        self._values[name].extend(arr.tolist())

    def increment(self, name: str, amount: int = 1) -> None:
        self._counters[name] += amount

    def get_stats(self, name: str) -> Dict[str, float]:
        vals = self._values.get(name)
        if not vals:
            return {"count": 0}
        arr = np.asarray(vals)
        return {
            "count": len(arr),
            "mean": float(arr.mean()),
            "std": float(arr.std()),
            "min": float(arr.min()),
            "max": float(arr.max()),
            "last": float(arr[-1]),
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "metrics": {k: self.get_stats(k) for k in self._values},
            "counters": dict(self._counters),
        }


class EnvironmentMonitor:
    """Episode/step statistics and health classification for batched envs:
    feed it per-step metric arrays (numpy, on the host) and it aggregates
    across the batch."""

    def __init__(self, log_level: str = "WARNING", window: int = 1000):
        logger.setLevel(getattr(logging, log_level.upper(), logging.WARNING))
        self.metrics = MetricsCollector(window)
        self.episode_count = 0
        self.step_count = 0
        self.error_log: List[Dict[str, Any]] = []
        self._episode_start: Optional[float] = None
        self._step_start: Optional[float] = None

    def start_episode(self) -> None:
        self._episode_start = time.perf_counter()

    def end_episode(self, total_reward: float, success: bool) -> None:
        self.episode_count += 1
        if self._episode_start is not None:
            self.metrics.record(
                "episode_duration_s", time.perf_counter() - self._episode_start
            )
        self.metrics.record("episode_reward", total_reward)
        self.metrics.record("episode_success", float(success))

    def start_step(self) -> None:
        self._step_start = time.perf_counter()

    def end_step(self, reward, info: Optional[Dict[str, Any]] = None) -> None:
        self.step_count += 1
        if self._step_start is not None:
            self.metrics.record(
                "step_duration_s", time.perf_counter() - self._step_start
            )
        self.metrics.record_batch("step_reward", reward)
        if info:
            for k in ("step_energy", "current_alignment", "is_success"):
                if k in info:
                    self.metrics.record_batch(k, np.asarray(info[k], dtype=float))

    def record_rollout(self, summary: Dict[str, Any]) -> None:
        """Aggregate a rollout summary of host numbers (``parallel.summarize``
        read back)."""
        for k, v in summary.items():
            self.metrics.record(k, float(np.asarray(v)))

    def log_error(self, error: Exception, context: str = "") -> None:
        self.error_log.append(
            {"time": time.time(), "error": str(error), "context": context}
        )
        logger.error("%s: %s", context, error)
        if len(self.error_log) > 1000:
            self.error_log = self.error_log[-500:]

    def log_warning(self, message: str, context: str = "") -> None:
        logger.warning("%s: %s", context, message)

    def get_health_report(self) -> Dict[str, Any]:
        """HEALTHY / WARNING / CRITICAL classification."""
        report: Dict[str, Any] = {
            "status": "HEALTHY",
            "episode_count": self.episode_count,
            "step_count": self.step_count,
            "error_count": len(self.error_log),
            "metrics": self.metrics.summary(),
        }
        recent_errors = [
            e for e in self.error_log if time.time() - e["time"] < 300
        ]
        if len(recent_errors) > 10:
            report["status"] = "CRITICAL"
        elif recent_errors:
            report["status"] = "WARNING"
        reward_stats = self.metrics.get_stats("step_reward")
        if reward_stats.get("count", 0) and not np.isfinite(
            reward_stats.get("mean", 0.0)
        ):
            report["status"] = "CRITICAL"
        return report


class SafetyWrapper:
    """Host-side action/observation/reward validation with the reference's
    clamp limits. The env step applies the same clamps on the device; this
    class is for host loops that want explicit pre-validation and logging."""

    def __init__(self, monitor: Optional[EnvironmentMonitor] = None):
        self.monitor = monitor or EnvironmentMonitor()
        self.safety_limits = {
            "max_current": 1e8,
            "max_duration": 1e-6,
            "max_temperature": 1000.0,
            "min_temperature": 0.0,
        }

    def validate_action(self, action: np.ndarray) -> np.ndarray:
        action = np.asarray(action, dtype=np.float32)
        if action.ndim == 1 and action.shape[0] == 2:
            batched = action[None, :]
        elif action.ndim == 2 and action.shape[-1] == 2:
            batched = action
        else:
            self.monitor.log_warning(f"Invalid action shape: {action.shape}", "safety")
            return np.array([0.0, 1e-12], dtype=np.float32)
        out = batched.copy()
        out[:, 0] = np.clip(
            out[:, 0], -self.safety_limits["max_current"], self.safety_limits["max_current"]
        )
        out[:, 1] = np.clip(out[:, 1], 1e-12, self.safety_limits["max_duration"])
        bad = ~np.isfinite(out).all(axis=-1)
        if bad.any():
            self.monitor.log_warning("NaN/Inf detected in action", "safety")
            out[bad] = [0.0, 1e-12]
        return out[0] if action.ndim == 1 else out

    def validate_observation(self, observation):
        obs = np.asarray(observation)
        if not np.isfinite(obs).all():
            self.monitor.log_warning("NaN/Inf detected in observation", "safety")
            obs = np.nan_to_num(obs, nan=0.0, posinf=1e6, neginf=-1e6)
        return obs

    def validate_reward(self, reward):
        arr = np.asarray(reward, dtype=float)
        bad = ~np.isfinite(arr)
        if bad.any():
            self.monitor.log_warning("Invalid reward", "safety")
            arr = np.where(bad, -1.0, arr)
        arr = np.clip(arr, -1e6, 1e6)
        return float(arr) if np.ndim(reward) == 0 else arr


class HealthMonitor:
    """Aggregates named health checks."""

    def __init__(self):
        self._checks: Dict[str, Any] = {}

    def register(self, name: str, check) -> None:
        self._checks[name] = check

    def run(self) -> Dict[str, Any]:
        results = {}
        overall = "HEALTHY"
        for name, check in self._checks.items():
            try:
                ok, detail = check()
                results[name] = {"ok": bool(ok), "detail": detail}
                if not ok:
                    overall = "WARNING"
            except Exception as e:  # noqa: BLE001
                results[name] = {"ok": False, "detail": str(e)}
                overall = "CRITICAL"
        return {"status": overall, "checks": results}


def default_health_monitor(device=None) -> HealthMonitor:
    """Built-in checks on ``device`` (the card unless the caller passes
    "cpu"): the device is reachable, and one sum computed there is right."""
    import torch

    from ..parallel.mesh import resolve_device

    hm = HealthMonitor()

    def backend_check():
        d = resolve_device(device, None)
        n = torch.cuda.device_count()
        return d.type == "cpu" or n > 0, f"{d.type}, {n} CUDA devices"

    def compute_check():
        d = resolve_device(device, None)
        v = float(torch.sum(torch.tensor([1.0, 2.0, 2.0], device=d)))
        return abs(v - 5.0) < 1e-6, f"sum={v}"

    hm.register("backend", backend_check)
    hm.register("compute", compute_check)
    return hm
