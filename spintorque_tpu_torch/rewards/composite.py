"""Composite reward: weighted, normalized, clipped component sum.

PyTorch counterpart of ``spintorque_tpu/rewards/composite.py``. The running
normalization is a per-env Welford update of a RunningStat carried in the
environment state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .components import RewardContext, resolve


@dataclasses.dataclass(frozen=True)
class RunningStat:
    """Per-env running moments of one reward component."""

    count: Any  # (B,)
    mean: Any  # (B,)
    m2: Any  # (B,) sum of squared deviations
    min: Any  # (B,)
    max: Any  # (B,)

    @classmethod
    def create(cls, batch: int, dtype=torch.float32, *, device) -> "RunningStat":
        big = torch.finfo(dtype).max
        return cls(
            count=torch.zeros((batch,), dtype=dtype, device=device),
            mean=torch.zeros((batch,), dtype=dtype, device=device),
            m2=torch.zeros((batch,), dtype=dtype, device=device),
            min=torch.full((batch,), big, dtype=dtype, device=device),
            max=torch.full((batch,), -big, dtype=dtype, device=device),
        )

    def update(self, value) -> "RunningStat":
        count = self.count + 1.0
        delta = value - self.mean
        mean = self.mean + delta / count
        m2 = self.m2 + delta * (value - mean)
        return RunningStat(
            count=count,
            mean=mean,
            m2=m2,
            min=torch.minimum(self.min, value),
            max=torch.maximum(self.max, value),
        )

    def std(self):
        return torch.sqrt(self.m2 / torch.clamp_min(self.count, 1.0))


class CompositeReward:
    """Composite-reward configuration + compute function.

    components: {name: {'weight': float, 'function': callable|registry-name,
                        'normalize': None|'running_mean'|'running_std'|
                                     'unit_range'|{'mean','std'}|{'min','max'},
                        'clip': None|(lo, hi)}}
    """

    def __init__(self, components: Dict[str, Dict[str, Any]]):
        self.components = {}
        self.total_weight = 0.0
        # Raised by every change of the components (a captured env step
        # bakes their weights, normalizations and clips in).
        self.version = 0
        for name, config in components.items():
            self._add(name, config)

    def _add(self, name: str, config: Dict[str, Any]) -> None:
        if "weight" not in config:
            raise ValueError(f"Component '{name}' missing required 'weight'")
        if "function" not in config:
            raise ValueError(f"Component '{name}' missing required 'function'")
        self.components[name] = {
            "weight": float(config["weight"]),
            "function": resolve(config["function"]),
            "normalize": config.get("normalize", None),
            "clip": config.get("clip", None),
        }
        self.total_weight += abs(float(config["weight"]))
        self.version += 1

    def add_component(self, name, weight, function, normalize=None, clip=None):
        self._add(name, {"weight": weight, "function": function,
                         "normalize": normalize, "clip": clip})

    def remove_component(self, name: str) -> None:
        if name in self.components:
            self.total_weight -= abs(self.components[name]["weight"])
            del self.components[name]
            self.version += 1

    def update_weight(self, name: str, new_weight: float) -> None:
        if name not in self.components:
            raise ValueError(f"Component '{name}' not found")
        self.total_weight -= abs(self.components[name]["weight"])
        self.components[name]["weight"] = float(new_weight)
        self.total_weight += abs(new_weight)
        self.version += 1

    def get_component_names(self):
        return list(self.components)

    @property
    def needs_stats(self) -> bool:
        return any(isinstance(c["normalize"], str) for c in self.components.values())

    def init_stats(self, batch: int, dtype=torch.float32, *, device) -> Dict[str, RunningStat]:
        return {
            name: RunningStat.create(batch, dtype, device=device)
            for name, c in self.components.items()
            if isinstance(c["normalize"], str)
        }

    def compute(
        self,
        ctx: RewardContext,
        stats: Optional[Dict[str, RunningStat]] = None,
    ) -> Tuple[Any, Dict[str, Any], Dict[str, RunningStat]]:
        """Returns (total (B,), per-component dict, updated stats).

        running_mean subtracts the running mean, running_std standardizes,
        unit_range maps into [0, 1] by the running min/max, and dict configs
        use explicit constants. A value is normalized against the pre-update
        history, which then absorbs the post-normalize, post-clip value.
        """
        stats = dict(stats or {})
        total = None
        breakdown: Dict[str, Any] = {}
        for name, c in self.components.items():
            value = c["function"](ctx)
            norm = c["normalize"]
            needs_stat_update = False
            if isinstance(norm, str):
                st = stats[name]
                has_history = st.count > 0
                if norm == "running_mean":
                    value = torch.where(has_history, value - st.mean, value)
                elif norm == "running_std":
                    has2 = st.count > 1
                    value = torch.where(has2, (value - st.mean) / (st.std() + 1e-8), value)
                elif norm == "unit_range":
                    span = st.max - st.min
                    value = torch.where(
                        has_history & (span > 0), (value - st.min) / span, value
                    )
                else:
                    raise ValueError(f"Unknown normalization method: {norm}")
                needs_stat_update = True
            elif isinstance(norm, dict):
                if "mean" in norm and "std" in norm:
                    value = (value - norm["mean"]) / (norm["std"] + 1e-8)
                elif "min" in norm and "max" in norm:
                    if norm["max"] > norm["min"]:
                        value = (value - norm["min"]) / (norm["max"] - norm["min"])
                else:
                    raise ValueError(f"Invalid normalization config: {norm}")
            if c["clip"] is not None:
                lo, hi = c["clip"]
                value = torch.clamp(value, lo, hi)
            if needs_stat_update:
                stats[name] = stats[name].update(value)
            weighted = c["weight"] * value
            breakdown[name] = value
            total = weighted if total is None else total + weighted
        if total is None:
            total = torch.zeros_like(ctx.alignment)
        return total, breakdown, stats

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{n}: weight={c['weight']:.3f}" for n, c in self.components.items()
        )
        return f"CompositeReward({parts})"
