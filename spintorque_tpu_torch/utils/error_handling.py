"""Exception hierarchy, retry decorator and safe math.

PyTorch counterpart of ``spintorque_tpu/utils/error_handling.py``. The
env step and the pulse kernel do not raise on bad numbers: robustness
there is by construction (``PulseResult.failed``, the normalization's
fallback to +z). These utilities serve host-side setup and IO code, with
the JAX package's exception taxonomy, so except-clauses carry over.

The safe math takes numpy arrays, Python numbers and torch tensors. A
numpy or number input gives the JAX package's numpy result; a tensor gives
a tensor of the same computation on the tensor's device, in its dtype
(float64 for an integer tensor).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Any, Callable, Optional, Tuple, Type

import numpy as np
import torch

logger = logging.getLogger("spintorque_tpu_torch")


class SpinTorqueError(Exception):
    """Base error."""


class PhysicsError(SpinTorqueError):
    pass


class DeviceError(SpinTorqueError):
    pass


class EnvironmentError_(SpinTorqueError):
    pass


class ValidationError(SpinTorqueError):
    pass


class NumericalError(SpinTorqueError):
    pass


class ConfigurationError(SpinTorqueError):
    pass


def robust_computation(
    max_retries: int = 3,
    backoff: float = 0.1,
    exceptions: Tuple[Type[Exception], ...] = (Exception,),
    fallback: Optional[Callable[..., Any]] = None,
):
    """Retry decorator: up to ``max_retries`` retries after the first try,
    sleeping ``backoff * 2**attempt`` between them, then ``fallback`` (called
    with the same arguments) or the last exception."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            last = None
            for attempt in range(max_retries + 1):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:  # noqa: PERF203
                    last = e
                    if attempt < max_retries:
                        logger.warning(
                            "%s failed (attempt %d/%d): %s",
                            fn.__name__, attempt + 1, max_retries, e,
                        )
                        time.sleep(backoff * (2**attempt))
            if fallback is not None:
                return fallback(*args, **kwargs)
            raise last

        return wrapper

    return decorator


def safe_execute(fn: Callable, *args, default: Any = None, **kwargs):
    """Run fn, returning ``default`` on exception."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001
        logger.warning("safe_execute(%s) failed: %s", getattr(fn, "__name__", fn), e)
        return default


# ---- safe math: numpy in, numpy out (the JAX package's); tensor in, tensor out ----

def _float_tensor(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float64)


def safe_division(a, b, default: float = 0.0):
    """a / b, ``default`` where b == 0."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ref = a if isinstance(a, torch.Tensor) else b
        b_t = _float_tensor(torch.as_tensor(b, device=ref.device))
        a_t = torch.as_tensor(a, device=ref.device)
        zero = b_t == 0
        out = a_t / torch.where(zero, torch.ones_like(b_t), b_t)
        return torch.where(zero, torch.full_like(out, default), out)
    b_arr = np.asarray(b)
    out = np.divide(a, np.where(b_arr == 0, 1.0, b_arr))
    return np.where(b_arr == 0, default, out)


def safe_sqrt(x, default: float = 0.0):
    """sqrt(x), ``default`` where x < 0 (and for NaN)."""
    if isinstance(x, torch.Tensor):
        t = _float_tensor(x)
        return torch.where(t >= 0, torch.sqrt(t.abs()), torch.full_like(t, default))
    arr = np.asarray(x, dtype=float)
    return np.where(arr >= 0, np.sqrt(np.abs(arr)), default)


def safe_log(x, default: float = 0.0):
    """log(x), ``default`` where x <= 0 (and for NaN)."""
    if isinstance(x, torch.Tensor):
        t = _float_tensor(x)
        pos = t > 0
        return torch.where(pos, torch.log(torch.where(pos, t, torch.ones_like(t))),
                           torch.full_like(t, default))
    arr = np.asarray(x, dtype=float)
    return np.where(arr > 0, np.log(np.where(arr > 0, arr, 1.0)), default)


def safe_normalize(v, fallback=(0.0, 0.0, 1.0)):
    """v / |v| along the last axis, ``fallback`` where |v| < 1e-12 or is not
    finite."""
    if isinstance(v, torch.Tensor):
        t = _float_tensor(v)
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        ok = (norm >= 1e-12) & torch.isfinite(norm)
        fb = torch.as_tensor(fallback, dtype=t.dtype, device=t.device)
        return torch.where(ok, t / torch.where(ok, norm, torch.ones_like(norm)), fb)
    arr = np.asarray(v, dtype=float)
    norm = np.linalg.norm(arr, axis=-1, keepdims=True)
    ok = (norm >= 1e-12) & np.isfinite(norm)
    out = np.where(ok, arr / np.where(ok, norm, 1.0), np.asarray(fallback))
    return out


class ErrorRecoveryManager:
    """Tracks failures per context within a time window; ``should_abort``
    once a context reaches ``max_failures``."""

    def __init__(self, max_failures: int = 5, window_s: float = 300.0):
        self.max_failures = max_failures
        self.window_s = window_s
        self._failures: dict[str, list[float]] = {}

    def record_failure(self, context: str) -> None:
        now = time.time()
        lst = self._failures.setdefault(context, [])
        lst.append(now)
        self._failures[context] = [t for t in lst if now - t < self.window_s]

    def should_abort(self, context: str) -> bool:
        return len(self._failures.get(context, [])) >= self.max_failures

    def reset(self, context: Optional[str] = None) -> None:
        if context is None:
            self._failures.clear()
        else:
            self._failures.pop(context, None)
