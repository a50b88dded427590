"""Utilities (only the throughput measurement is ported so far)."""

from .benchmark import measure_env_throughput

__all__ = ["measure_env_throughput"]
