"""Quantum-module benchmark suite.

PyTorch counterpart of ``spintorque_tpu/quantum/benchmarking.py``. The
scenarios time the real programs on the suite's device (the card unless
the caller asks for "cpu"): a state-vector batch (12 qubits, depth 20,
batch 64), the QAOA angle grid (10 variables, grid 24) and surface-code
Monte Carlo (500,000 trials), each after one warm-up call, every timed
call ending in a ``torch.cuda.synchronize`` on the card, with bootstrap CIs
from the shared ``research.benchmarking`` statistics. The report names the
card and its power limit (``BenchmarkSuite.run``).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np

from ..research.benchmarking import BenchmarkResult, BenchmarkSuite, _sync, bootstrap_ci
from . import statevector as sv
from .circuits import QuantumCircuit
from .error_correction import SurfaceCodeErrorCorrection
from .optimization import IterationFreeQAOA

__all__ = [
    "BenchmarkResult",
    "QuantumBenchmarkSuite",
    "create_standard_benchmark_suite",
]


def _time_repeats(fn: Callable[[], Any], device, repeats: int = 5) -> np.ndarray:
    fn()  # warm-up
    _sync(device)
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append(time.perf_counter() - t0)
    return np.asarray(out)


def _statevector_scenario(device, n_qubits: int = 12, depth: int = 20, batch: int = 64):
    def run() -> BenchmarkResult:
        circ = QuantumCircuit(n_qubits, device=device)
        rng = np.random.default_rng(0)
        for d in range(depth):
            for w in range(n_qubits):
                circ.add("RY", w, float(rng.uniform(0, np.pi)))
            for w in range(d % 2, n_qubits - 1, 2):
                circ.cz(w, w + 1)

        base = sv.zero_state(n_qubits, device=device)
        states = base.expand((batch,) + base.shape)
        times = _time_repeats(lambda: circ.run(state=states), device)
        rates = batch * len(circ.gates) / times
        return BenchmarkResult(
            name=f"statevector_{n_qubits}q_d{depth}_b{batch}",
            value=float(rates.mean()),
            unit="gate_applications/s",
            std=float(rates.std()),
            ci95=bootstrap_ci(rates),
            extra={
                "n_qubits": n_qubits,
                "depth": depth,
                "batch": batch,
                "n_gates": len(circ.gates),
            },
        )

    return run


def _qaoa_scenario(device, n_vars: int = 10, grid_points: int = 24):
    def run() -> BenchmarkResult:
        rng = np.random.default_rng(1)
        Q = rng.normal(size=(n_vars, n_vars))
        Q = np.triu(Q)
        qaoa = IterationFreeQAOA(grid_points=grid_points, device=device)
        t0 = time.perf_counter()
        result = qaoa.optimize(Q)  # ends in host reads of its argmin and argmax
        elapsed = time.perf_counter() - t0
        evals_per_s = result.n_evaluations / elapsed
        return BenchmarkResult(
            name=f"qaoa_{n_vars}vars_{grid_points}grid",
            value=float(evals_per_s),
            unit="angle_evaluations/s",
            extra={
                "n_evaluations": result.n_evaluations,
                "best_value": result.best_value,
                "elapsed_s": elapsed,
            },
        )

    return run


def _surface_code_scenario(device, n_trials: int = 500_000, p: float = 0.01):
    def run() -> BenchmarkResult:
        code = SurfaceCodeErrorCorrection(device)
        times = _time_repeats(
            lambda: code.logical_error_rate(p, n_trials=n_trials)["logical_x_rate"],
            device, repeats=3,
        )
        rate = 2 * n_trials / times  # X and Z decodes per call
        return BenchmarkResult(
            name=f"surface_code_decode_{n_trials}",
            value=float(rate.mean()),
            unit="decodes/s",
            std=float(rate.std()),
            ci95=bootstrap_ci(rate),
            extra={"physical_rate": p, "n_trials": n_trials},
        )

    return run


class QuantumBenchmarkSuite(BenchmarkSuite):
    """BenchmarkSuite pre-registered with the quantum scenarios."""

    def __init__(self, name: str = "spintorque_tpu_torch_quantum", device=None):
        super().__init__(name, device=device)
        self.register("statevector", _statevector_scenario(self.device))
        self.register("qaoa", _qaoa_scenario(self.device))
        self.register("surface_code", _surface_code_scenario(self.device))


def create_standard_benchmark_suite(device=None) -> QuantumBenchmarkSuite:
    """The quantum suite at its default sizes on ``device``."""
    return QuantumBenchmarkSuite(device=device)
