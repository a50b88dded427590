"""Rollout collection (single device; the mesh path is not ported yet)."""

from .rollout import Trajectory, random_policy, rollout, summarize

__all__ = ["Trajectory", "random_policy", "rollout", "summarize"]
