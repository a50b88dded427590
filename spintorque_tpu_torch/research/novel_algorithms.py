"""Meta-learning, quantum-inspired annealing, and hypothesis-driven search.

PyTorch counterpart of ``spintorque_tpu/research/novel_algorithms.py``. All
three are classical, whatever the names say, and import nothing of a
quantum tier: the meta-learner adapts the cross-entropy method's
hyperparameters across tasks from the objective values it reaches; the
"quantum-inspired" optimizer is population annealing whose tunneling
schedule mimics a transverse field (long-range jump proposals that anneal
away), with the whole population evaluated in one objective call an
iteration; the experiment engine runs pre-registered hypotheses against
fresh data with real tests and a Holm-Bonferroni correction.

The searches run on ``device`` (the card unless the caller asks for
"cpu") and draw from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .optimizers import OptimizationResult, cross_entropy

Tensor = torch.Tensor

__all__ = [
    "AdaptiveMetaLearner",
    "QuantumInspiredSpintronicOptimizer",
    "Hypothesis",
    "HypothesisDrivenExperimentEngine",
]


class AdaptiveMetaLearner:
    """Cross-task hyperparameter adaptation for population optimizers.

    Maintains a bank of CEM hyperparameter configurations with running
    scores; each new task is solved with the current best configuration
    (epsilon-greedy over the bank), and the achieved objective updates the
    scores. This is the reference AdaptiveMetaLearner's capability - "learn
    how to optimize from previous optimizations" - with a measurable
    mechanism instead of pseudo-gradient rules.
    """

    CONFIG_BANK = (
        {"population": 512, "elites": 32, "iterations": 15, "smoothing": 0.7},
        {"population": 1024, "elites": 64, "iterations": 10, "smoothing": 0.5},
        {"population": 256, "elites": 16, "iterations": 30, "smoothing": 0.3},
        {"population": 2048, "elites": 128, "iterations": 8, "smoothing": 0.5},
    )

    def __init__(self, epsilon: float = 0.2, seed: int = 0, device=None):
        self.epsilon = epsilon
        self.device = resolve_device(device, None)
        self._rng = np.random.default_rng(seed)
        self._scores = [[] for _ in self.CONFIG_BANK]
        self.history: List[Dict[str, Any]] = []

    def _select(self) -> int:
        untried = [i for i, s in enumerate(self._scores) if not s]
        if untried:
            return untried[0]
        if self._rng.uniform() < self.epsilon:
            return int(self._rng.integers(len(self.CONFIG_BANK)))
        means = [np.mean(s) for s in self._scores]
        return int(np.argmin(means))  # lower objective = better

    def solve(
        self,
        objective: Callable[[Dict[str, Tensor]], Tensor],
        space: Dict[str, Tuple[float, float]],
        seed: int = 0,
    ) -> OptimizationResult:
        idx = self._select()
        cfg = self.CONFIG_BANK[idx]
        result = cross_entropy(objective, space, seed=seed, device=self.device, **cfg)
        self._scores[idx].append(result.best_value)
        self.history.append(
            {"config_index": idx, "config": dict(cfg), "best_value": result.best_value}
        )
        return result

    def meta_report(self) -> Dict[str, Any]:
        return {
            "tasks_solved": len(self.history),
            "config_scores": [
                {"config": dict(c), "n_used": len(s),
                 "mean_objective": float(np.mean(s)) if s else None}
                for c, s in zip(self.CONFIG_BANK, self._scores)
            ],
        }


class QuantumInspiredSpintronicOptimizer:
    """Population annealing with a transverse-field-style tunneling schedule.

    Proposal distribution per iteration mixes local Gaussian moves with
    long-range uniform "tunneling" jumps; the tunneling probability Gamma(t)
    anneals from gamma0 to ~0 (the transverse-field analogy - exploration
    that cannot be reached by local thermal moves), while the Metropolis
    temperature anneals alongside. All ``population`` candidates evaluate in
    one objective call per iteration; candidates live in the unit cube in
    float64 and the objective's values are taken in float32, as the JAX
    package's.
    """

    def __init__(
        self,
        population: int = 1024,
        iterations: int = 40,
        gamma0: float = 0.5,
        t0: float = 1.0,
        local_scale: float = 0.1,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device, None)
        self.population = population
        self.iterations = iterations
        self.gamma0 = gamma0
        self.t0 = t0
        self.local_scale = local_scale
        self.seed = seed

    def optimize(
        self,
        objective: Callable[[Dict[str, Tensor]], Tensor],
        space: Dict[str, Tuple[float, float]],
    ) -> OptimizationResult:
        names = list(space)
        device = self.device
        lo = torch.tensor([space[n][0] for n in names], dtype=torch.float32, device=device)
        hi = torch.tensor([space[n][1] for n in names], dtype=torch.float32, device=device)
        dim = len(names)
        P, iters = self.population, self.iterations
        generator = torch.Generator(device=device).manual_seed(self.seed)

        def draw(fn, shape):
            return fn(shape, generator=generator, dtype=torch.float64, device=device)

        def evaluate(x01):
            x = lo + (hi - lo) * x01
            return torch.as_tensor(objective({n: x[:, i] for i, n in enumerate(names)}),
                                   dtype=torch.float32, device=device)

        x = draw(torch.rand, (P, dim))
        f = evaluate(x)

        history = []
        best_x, best_f = x[torch.argmin(f)], torch.min(f)
        for t in range(iters):
            frac = t / max(iters - 1, 1)
            gamma = self.gamma0 * (1.0 - frac)  # transverse field anneal
            temp = self.t0 * (1.0 - frac) + 1e-3
            tunneling = draw(torch.rand, (P, 1)) < gamma
            local = x + self.local_scale * (1 - frac) * draw(torch.randn, (P, dim))
            jump = draw(torch.rand, (P, dim))
            proposal = torch.clamp(torch.where(tunneling, jump, local), 0.0, 1.0)
            f_prop = evaluate(proposal)
            accept = (f_prop < f) | (draw(torch.rand, (P,)) < torch.exp(-(f_prop - f) / temp))
            x = torch.where(accept[:, None], proposal, x)
            f = torch.where(accept, f_prop, f)
            i = torch.argmin(f)
            better = f[i] < best_f
            best_x = torch.where(better, x[i], best_x)
            best_f = torch.where(better, f[i], best_f)
            history.append(best_f)

        best = lo + (hi - lo) * best_x
        return OptimizationResult(
            best_params={n: float(best[i]) for i, n in enumerate(names)},
            best_value=float(best_f),
            history=torch.stack(history).cpu().numpy().astype(float),
            n_evaluations=P * (iters + 1),
            method="quantum_inspired_annealing",
        )


@dataclass
class Hypothesis:
    """A pre-registered, falsifiable claim about experiment outcomes."""

    name: str
    description: str
    # test(results) -> (statistic dict, supported: bool)
    test: Callable[[Dict[str, np.ndarray]], Tuple[Dict[str, float], bool]]
    status: str = "untested"  # untested | supported | rejected
    evidence: Dict[str, float] = field(default_factory=dict)


class HypothesisDrivenExperimentEngine:
    """Pre-register hypotheses, run experiments, evaluate with real tests.

    The reference's HypothesisDrivenExperimentEngine generates "hypotheses"
    and marks them confirmed from single runs; this engine requires each
    hypothesis to come with a statistical test over a named experiment's
    results, runs experiments with independent seeds, and applies
    Holm-Bonferroni correction across the whole pre-registered family.
    """

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.hypotheses: List[Hypothesis] = []
        self.experiments: Dict[str, Callable[[int], Dict[str, float]]] = {}
        self.results: Dict[str, Dict[str, np.ndarray]] = {}

    def register_experiment(
        self, name: str, run_fn: Callable[[int], Dict[str, float]]
    ) -> None:
        """run_fn(seed) -> {metric: value}; called once per repeat."""
        self.experiments[name] = run_fn

    def register_hypothesis(self, hypothesis: Hypothesis) -> None:
        if any(h.name == hypothesis.name for h in self.hypotheses):
            raise ValueError(f"duplicate hypothesis {hypothesis.name}")
        self.hypotheses.append(hypothesis)

    def run_experiments(self, n_repeats: int = 10, base_seed: int = 0) -> None:
        for name, fn in self.experiments.items():
            rows = [fn(base_seed + r) for r in range(n_repeats)]
            self.results[name] = {
                k: np.asarray([row[k] for row in rows]) for k in rows[0]
            }

    def evaluate(self) -> Dict[str, Any]:
        if not self.results:
            raise RuntimeError("run_experiments first")
        merged: Dict[str, np.ndarray] = {}
        for exp_name, metrics in self.results.items():
            for k, v in metrics.items():
                merged[f"{exp_name}.{k}"] = v

        raw: List[Tuple[Hypothesis, Dict[str, float], bool]] = []
        for h in self.hypotheses:
            stats, supported = h.test(merged)
            raw.append((h, stats, supported))

        # Holm-Bonferroni over hypotheses that report a p_value
        with_p = sorted(
            [r for r in raw if "p_value" in r[1]], key=lambda r: r[1]["p_value"]
        )
        m = len(with_p)
        rejected_null = set()
        for rank, (h, stats, _) in enumerate(with_p):
            if stats["p_value"] <= self.alpha / (m - rank):
                rejected_null.add(h.name)
            else:
                break  # Holm: stop at first failure

        report = {"hypotheses": [], "alpha": self.alpha, "n_hypotheses": len(raw)}
        for h, stats, supported in raw:
            if "p_value" in stats:
                significant = h.name in rejected_null
                h.status = "supported" if (supported and significant) else "rejected"
                stats = {**stats, "significant_after_correction": significant}
            else:
                h.status = "supported" if supported else "rejected"
            h.evidence = stats
            report["hypotheses"].append(
                {"name": h.name, "description": h.description,
                 "status": h.status, "evidence": stats}
            )
        return report
