"""Host-side input validation.

The port's own copy of ``spintorque_tpu/utils/validation.py`` (numpy only,
as there). These run at setup and adapter boundaries, on the host; inside
the env step validation is by construction (masked loops, the
normalization's fallback). Every validator also takes torch tensors,
which it copies to the host first (``utils.host.as_numpy``), and returns
numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .host import as_numpy


class ValidationError(Exception):
    """Raised for invalid physics/env inputs."""


class PhysicsValidator:
    @staticmethod
    def validate_magnetization(magnetization, name: str = "magnetization") -> np.ndarray:
        """Normalize-or-raise; batched shapes allowed."""
        try:
            m = np.asarray(as_numpy(magnetization), dtype=float)
        except (ValueError, TypeError) as e:
            raise ValidationError(f"{name} must be convertible to numpy array") from e
        if m.shape[-1] != 3:
            raise ValidationError(f"{name} must be a 3D vector, got shape {m.shape}")
        if not np.all(np.isfinite(m)):
            raise ValidationError(f"{name} contains non-finite values")
        mag = np.linalg.norm(m, axis=-1, keepdims=True)
        if np.any(mag < 1e-12):
            raise ValidationError(f"{name} has zero magnitude")
        out = m / mag
        if not np.all(np.isfinite(out)):
            raise ValidationError(f"{name} normalization failed")
        return out

    @staticmethod
    def validate_field(field, name: str = "field") -> np.ndarray:
        f = np.asarray(as_numpy(field), dtype=float)
        if f.shape[-1] != 3:
            raise ValidationError(f"{name} must be a 3D vector")
        if not np.all(np.isfinite(f)):
            raise ValidationError(f"{name} contains non-finite values")
        if np.any(np.abs(f) > 1e10):
            raise ValidationError(f"{name} magnitude unreasonably large")
        return f

    @staticmethod
    def validate_positive_scalar(value, name: str = "value") -> float:
        v = float(as_numpy(value))
        if not np.isfinite(v) or v <= 0:
            raise ValidationError(f"{name} must be a positive finite number")
        return v

    @staticmethod
    def validate_device_params(params: Dict[str, Any]) -> Dict[str, Any]:
        """Range checks of the known fields."""
        if "volume" in params:
            PhysicsValidator.validate_positive_scalar(params["volume"], "volume")
        if "saturation_magnetization" in params:
            PhysicsValidator.validate_positive_scalar(
                params["saturation_magnetization"], "saturation_magnetization"
            )
        if "damping" in params and not 0 <= float(as_numpy(params["damping"])) <= 1:
            raise ValidationError("damping must be in [0, 1]")
        if "polarization" in params and not 0 <= float(as_numpy(params["polarization"])) <= 1:
            raise ValidationError("polarization must be in [0, 1]")
        if "temperature" in params and float(as_numpy(params["temperature"])) < 0:
            raise ValidationError("temperature must be non-negative")
        return params


class ActionValidator:
    """Action range validation."""

    def __init__(self, max_current: float = 2e6, max_duration: float = 5e-9):
        self.max_current = max_current
        self.max_duration = max_duration

    def validate(self, action) -> np.ndarray:
        a = np.asarray(as_numpy(action), dtype=float)
        if not np.all(np.isfinite(a)):
            raise ValidationError("action contains non-finite values")
        return a

    def clip(self, action) -> np.ndarray:
        a = np.asarray(as_numpy(action), dtype=float).copy()
        a[..., 0] = np.clip(a[..., 0], -self.max_current, self.max_current)
        if a.shape[-1] > 1:
            a[..., 1] = np.clip(a[..., 1], 1e-12, self.max_duration)
        return a


class NumericalValidator:
    """Finite-value / range guards."""

    @staticmethod
    def check_finite(x, name: str = "array"):
        arr = np.asarray(as_numpy(x))
        if not np.all(np.isfinite(arr)):
            raise ValidationError(f"{name} contains non-finite values")
        return arr

    @staticmethod
    def check_range(x, lo: float, hi: float, name: str = "array"):
        arr = np.asarray(as_numpy(x))
        if np.any(arr < lo) or np.any(arr > hi):
            raise ValidationError(f"{name} outside [{lo}, {hi}]")
        return arr


# Module-level helpers
def validate_magnetization(m, name: str = "magnetization") -> np.ndarray:
    return PhysicsValidator.validate_magnetization(m, name)


def validate_parameters(params: Dict[str, Any], device_type: str = "stt_mram"):
    return PhysicsValidator.validate_device_params(params)


def validate_action(action, max_current: float = 2e6, max_duration: float = 5e-9):
    return ActionValidator(max_current, max_duration).validate(action)


def validate_observation(obs):
    return NumericalValidator.check_finite(obs, "observation")


def validate_environment_config(config: Dict[str, Any]) -> Dict[str, Any]:
    if config.get("max_steps", 1) <= 0:
        raise ValidationError("max_steps must be positive")
    if config.get("max_current", 1.0) <= 0:
        raise ValidationError("max_current must be positive")
    if not 0 < config.get("success_threshold", 0.9) <= 1:
        raise ValidationError("success_threshold must be in (0, 1]")
    return config
