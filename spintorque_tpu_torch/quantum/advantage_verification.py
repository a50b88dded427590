"""Statistical verification of quantum-vs-classical performance claims.

PyTorch counterpart of ``spintorque_tpu/quantum/advantage_verification.py``
(host NumPy, as there): a paired-comparison harness that runs method A and
method B on the SAME problem instances and reports effect sizes with
bootstrap CIs and Welch tests (shared with ``research.benchmarking``). A
claim is "verified" only when the CI excludes no-difference or the
candidate is faster without being worse. A method that runs on the card
should end its call with a synchronize (or a host read, as a float result
does) for its time to be its own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from ..research.benchmarking import bootstrap_ci, significance_test

__all__ = ["AdvantageReport", "QuantumAdvantageVerifier", "PerformanceAnalytics"]


@dataclass
class AdvantageReport:
    claim: str
    speedup: float
    speedup_ci: tuple
    quality_delta: float
    quality_delta_ci: tuple
    p_value: float
    verified: bool
    details: Dict[str, Any] = field(default_factory=dict)


class QuantumAdvantageVerifier:
    """Paired A/B verification on identical problem instances.

    ``verify`` takes two callables ``method(instance) -> (value, elapsed_s)``
    (or just value - timing is measured here) plus an instance generator.
    Lower values = better (costs); pass ``maximize=True`` otherwise.
    """

    def __init__(self, n_instances: int = 20, alpha: float = 0.05, seed: int = 0):
        self.n_instances = n_instances
        self.alpha = alpha
        self.seed = seed

    def _run(self, method: Callable[[Any], Any], instances: Sequence[Any]):
        values, times = [], []
        for inst in instances:
            t0 = time.perf_counter()
            out = method(inst)
            elapsed = time.perf_counter() - t0
            if isinstance(out, tuple) and len(out) == 2:
                value, elapsed = out
            else:
                value = out
            values.append(float(value))
            times.append(float(elapsed))
        return np.asarray(values), np.asarray(times)

    def verify(
        self,
        claim: str,
        candidate: Callable[[Any], Any],
        baseline: Callable[[Any], Any],
        instance_generator: Callable[[int], Any],
        maximize: bool = False,
    ) -> AdvantageReport:
        instances = [instance_generator(i) for i in range(self.n_instances)]
        cand_vals, cand_times = self._run(candidate, instances)
        base_vals, base_times = self._run(baseline, instances)

        # paired quality difference (positive = candidate better)
        sign = 1.0 if maximize else -1.0
        deltas = sign * (cand_vals - base_vals)
        d_lo, d_hi = bootstrap_ci(deltas)
        stats = significance_test(cand_vals, base_vals)

        speedups = base_times / np.maximum(cand_times, 1e-12)
        s_lo, s_hi = bootstrap_ci(speedups)

        better_quality = d_lo > 0
        not_worse = d_lo > -1e-9 or stats["p_value"] > self.alpha
        faster = s_lo > 1.0
        verified = bool(better_quality or (faster and not_worse))

        return AdvantageReport(
            claim=claim,
            speedup=float(np.mean(speedups)),
            speedup_ci=(s_lo, s_hi),
            quality_delta=float(np.mean(deltas)),
            quality_delta_ci=(d_lo, d_hi),
            p_value=stats["p_value"],
            verified=verified,
            details={
                "candidate_mean": float(cand_vals.mean()),
                "baseline_mean": float(base_vals.mean()),
                "candidate_time_s": float(cand_times.mean()),
                "baseline_time_s": float(base_times.mean()),
                "cohens_d": stats["cohens_d"],
                "n_instances": self.n_instances,
                "criterion": (
                    "better_quality" if better_quality
                    else "faster_not_worse" if verified else "not_verified"
                ),
            },
        )


class PerformanceAnalytics:
    """Rolling performance statistics for repeated runs of named methods."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}

    def record(self, name: str, value: float) -> None:
        self._samples.setdefault(name, []).append(float(value))

    def record_timing(self, name: str, fn: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        out = fn()
        self.record(name, time.perf_counter() - t0)
        return out

    def summary(self, name: str) -> Dict[str, float]:
        xs = np.asarray(self._samples.get(name, []), float)
        if xs.size == 0:
            return {"count": 0}
        lo, hi = bootstrap_ci(xs) if xs.size > 1 else (float(xs[0]), float(xs[0]))
        return {
            "count": int(xs.size),
            "mean": float(xs.mean()),
            "std": float(xs.std(ddof=1)) if xs.size > 1 else 0.0,
            "min": float(xs.min()),
            "max": float(xs.max()),
            "ci95_low": lo,
            "ci95_high": hi,
        }

    def compare(self, a: str, b: str) -> Dict[str, float]:
        xa = np.asarray(self._samples.get(a, []), float)
        xb = np.asarray(self._samples.get(b, []), float)
        if xa.size < 2 or xb.size < 2:
            return {"error": -1.0}
        out = significance_test(xa, xb)
        out["ratio_of_means"] = float(xb.mean() / max(xa.mean(), 1e-300))
        return out

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: self.summary(name) for name in self._samples}
