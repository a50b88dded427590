"""Utilities (only the throughput measurements are ported so far)."""

from .benchmark import measure_env_throughput, measure_train_throughput

__all__ = ["measure_env_throughput", "measure_train_throughput"]
