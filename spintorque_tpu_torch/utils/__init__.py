"""Utilities: throughput measurements, checkpoints and profiling (the
numpy-only utilities of the JAX package are not ported yet)."""

from .benchmark import measure_env_throughput, measure_train_throughput
from .checkpoint import (
    CheckpointManager,
    load_env_state,
    load_params,
    load_pytree,
    load_train_state,
    save_env_state,
    save_params,
    save_pytree,
    save_train_state,
)
from .profiling import PerformanceProfiler, block_and_time, device_trace

__all__ = [
    "measure_env_throughput",
    "measure_train_throughput",
    "CheckpointManager",
    "load_env_state",
    "load_params",
    "load_pytree",
    "load_train_state",
    "save_env_state",
    "save_params",
    "save_pytree",
    "save_train_state",
    "PerformanceProfiler",
    "block_and_time",
    "device_trace",
]
