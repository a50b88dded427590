"""The traffic generator: actions drawn from the seed, as a workload's
``traffic`` parameters say.

``traffic`` holds ``current_levels``, a list of currents each drawn with
equal chance (``levels_from`` names where the list comes from: a current
drawn from a continuous range diverges at the upstream defaults, so the
levels hold zero); ``duration``, a [low, high] range of a uniform draw
``low + (high - low) * u``; and ``source``: ``card`` draws a (B, 2)
float32 action tensor on the card from a ``torch.Generator`` (the random
policy of a vectorized rollout); ``host`` draws a (B, 2) float32 numpy
array on the host, as a Gymnasium agent hands its action to
``env.step``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

MASK64 = 0xFFFFFFFFFFFFFFFF


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed (SplitMix64)."""
    z = (seed + (stream + 1) * 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1


# The uses of a run's seed.
ENV_STREAM = 0  # the env's reset and every draw keyed from its state
ACTION_STREAM = 1  # the actions
SAMPLE_STREAM = 2  # which steps the correctness check compares


class Actions:
    """Draws one step's actions for ``batch`` envs."""

    def __init__(self, traffic: Dict, batch: int, seed: int, device):
        self.batch = batch
        self.source = traffic["source"]
        self.levels = np.asarray(traffic["current_levels"], float)
        self.lo, self.hi = (float(x) for x in traffic["duration"])
        seed = subseed(seed, ACTION_STREAM)
        if self.source == "card":
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(seed)
            self.device = device
            self.card_levels = torch.tensor(self.levels, dtype=torch.float32, device=device)
        elif self.source == "host":
            self.rng = np.random.default_rng(seed)
        else:
            raise ValueError(f"unknown action source {self.source!r}")

    def __call__(self):
        n = len(self.levels)
        if self.source == "card":
            u = torch.rand((2, self.batch), generator=self.generator, dtype=torch.float32,
                           device=self.device)
            current = self.card_levels[(u[0] * n).long().clamp_(max=n - 1)]
            duration = self.lo + (self.hi - self.lo) * u[1]
            return torch.stack([current, duration], dim=-1)
        u = self.rng.random((self.batch, 2))
        current = self.levels[np.minimum((u[:, 0] * n).astype(int), n - 1)]
        duration = self.lo + (self.hi - self.lo) * u[:, 1]
        return np.stack([current, duration], axis=-1).astype(np.float32)
