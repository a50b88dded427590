"""QAOA-backed discrete device-design optimization and its benchmark.

PyTorch counterpart of ``spintorque_tpu/research/quantum_spintronics.py``.
Discrete design choices (material per layer, geometry bucket, pulse-polarity
pattern) are encoded as a QUBO whose linear/quadratic terms come from one
batched call of a physics objective, solved with the exact-simulation QAOA
(``quantum/optimization.py``); continuous parameters are then refined with
the cross-entropy method (``research.optimizers.cross_entropy``: with
``switching_objective`` one pulse-kernel launch a generation on the card).
The benchmark compares the quantum path against classical baselines with
the paired statistical verifier.

Everything runs on ``device`` (the card unless the caller asks for
"cpu"). The quantum tier's imports are deferred into methods, as in the JAX
package: ``research/__init__`` imports this module while
``spintorque_tpu_torch.quantum`` may still be mid-import
(``quantum/advantage_verification`` imports ``research.benchmarking``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .optimizers import OptimizationResult, cross_entropy

__all__ = ["QuantumSpintronicOptimizer", "QuantumSpintronicBenchmark"]


class QuantumSpintronicOptimizer:
    """Two-stage discrete+continuous device optimizer.

    Stage 1 (discrete): binary design variables x in {0,1}^n with objective
    x^T Q x; Q is either supplied or estimated from the physics objective by
    probing singles and pairs (n + n(n-1)/2 evaluations in ONE call).
    Solved by IterationFreeQAOA.
    Stage 2 (continuous): CEM refinement of continuous parameters with the
    chosen discrete design fixed.
    """

    def __init__(self, n_layers: int = 1, grid_points: int = 24, seed: int = 0, device=None):
        from ..quantum.optimization import IterationFreeQAOA

        self.device = resolve_device(device, None)
        self.qaoa = IterationFreeQAOA(n_layers=n_layers, grid_points=grid_points,
                                      device=self.device)
        self.seed = seed

    @staticmethod
    def estimate_qubo(
        objective: Callable[[np.ndarray], Any], n_vars: int
    ) -> np.ndarray:
        """Fit Q from objective evaluations at 0, singles, and pairs.

        objective takes a (B, n) 0/1 matrix and returns (B,) costs (an array
        or a tensor on any device); exact for true quadratic objectives, a
        2nd-order surrogate otherwise.
        """
        probes = [np.zeros(n_vars)]
        for i in range(n_vars):
            e = np.zeros(n_vars)
            e[i] = 1
            probes.append(e)
        pair_idx = []
        for i in range(n_vars):
            for j in range(i + 1, n_vars):
                e = np.zeros(n_vars)
                e[i] = e[j] = 1
                probes.append(e)
                pair_idx.append((i, j))
        vals = objective(np.stack(probes))
        vals = vals.detach().cpu().numpy() if isinstance(vals, torch.Tensor) else np.asarray(vals)
        f0 = vals[0]
        singles = vals[1 : 1 + n_vars] - f0
        Q = np.zeros((n_vars, n_vars))
        np.fill_diagonal(Q, singles)
        for (i, j), v in zip(pair_idx, vals[1 + n_vars :]):
            Q[i, j] = v - f0 - singles[i] - singles[j]
        return Q

    def optimize_discrete(
        self,
        objective: Optional[Callable[[np.ndarray], Any]] = None,
        Q: Optional[np.ndarray] = None,
        n_vars: Optional[int] = None,
    ) -> OptimizationResult:
        if Q is None:
            if objective is None or n_vars is None:
                raise ValueError("need Q, or objective + n_vars")
            Q = self.estimate_qubo(objective, n_vars)
        return self.qaoa.optimize(np.asarray(Q), seed=self.seed)

    def optimize(
        self,
        discrete_objective: Callable[[np.ndarray], Any],
        n_discrete: int,
        continuous_objective: Callable[[np.ndarray, Dict[str, torch.Tensor]], torch.Tensor],
        continuous_space: Dict[str, Tuple[float, float]],
        cem_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        discrete = self.optimize_discrete(
            objective=discrete_objective, n_vars=n_discrete
        )
        x = np.asarray(
            [discrete.best_params[f"x{i}"] for i in range(n_discrete)], np.float32
        )

        def bound_objective(params: Dict[str, torch.Tensor]) -> torch.Tensor:
            return continuous_objective(x, params)

        cont = cross_entropy(
            bound_objective, continuous_space, seed=self.seed, device=self.device,
            **(cem_kwargs or {"population": 512, "iterations": 10}),
        )
        return {
            "discrete": discrete,
            "continuous": cont,
            "design": x,
            "best_value": cont.best_value,
            "n_evaluations": discrete.n_evaluations + cont.n_evaluations,
        }


class QuantumSpintronicBenchmark:
    """Paired QAOA-vs-classical comparison on random device-design QUBOs.

    Classical baselines: exhaustive argmin (exact, the honest bar at small
    n) and greedy bit-flip local search (host NumPy). Reports come from
    QuantumAdvantageVerifier - verified only with CI-backed evidence.
    """

    def __init__(self, n_vars: int = 8, n_instances: int = 10, seed: int = 0, device=None):
        self.n_vars = n_vars
        self.n_instances = n_instances
        self.seed = seed
        self.device = resolve_device(device, None)

    def _instance(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + i)
        Q = rng.normal(size=(self.n_vars, self.n_vars))
        return np.triu(Q)

    @staticmethod
    def _cost(Q: np.ndarray, x: np.ndarray) -> float:
        return float(x @ Q @ x)

    def _qaoa_method(self, Q: np.ndarray) -> float:
        from ..quantum.optimization import IterationFreeQAOA

        qaoa = IterationFreeQAOA(grid_points=16, device=self.device)
        return qaoa.optimize(Q).best_value

    def _exhaustive(self, Q: np.ndarray) -> float:
        from ..quantum.optimization import IterationFreeQAOA

        return float(IterationFreeQAOA.qubo_cost_vector(Q, self.device).min())

    def _greedy(self, Q: np.ndarray) -> float:
        x = np.zeros(self.n_vars)
        improved = True
        while improved:
            improved = False
            for i in range(self.n_vars):
                flip = x.copy()
                flip[i] = 1 - flip[i]
                if self._cost(Q, flip) < self._cost(Q, x):
                    x = flip
                    improved = True
        return self._cost(Q, x)

    def run(self) -> Dict[str, Any]:
        from ..quantum.advantage_verification import QuantumAdvantageVerifier

        verifier = QuantumAdvantageVerifier(n_instances=self.n_instances)
        vs_greedy = verifier.verify(
            "QAOA beats greedy local search on device QUBOs",
            self._qaoa_method,
            self._greedy,
            self._instance,
        )
        vs_exact = verifier.verify(
            "QAOA matches exhaustive optimum on device QUBOs",
            self._qaoa_method,
            self._exhaustive,
            self._instance,
        )
        return {
            "qaoa_vs_greedy": vs_greedy,
            "qaoa_vs_exhaustive": vs_exact,
            "n_vars": self.n_vars,
            "n_instances": self.n_instances,
        }
