"""Rollout helpers (only ``random_policy`` is ported so far)."""

from .rollout import random_policy

__all__ = ["random_policy"]
