"""Research tooling: parameter optimization, benchmarking, validation.

PyTorch counterpart of ``spintorque_tpu/research``: the mesh-sharded
switching and parameter sweeps, population optimizers whose population is
one pulse-kernel launch, the benchmark suite and policy comparison,
gradient optimal control and the comparative analysis, the meta-learner,
annealer and hypothesis engine, the publication framework and the
classical validation checks. The quantum half (the JAX package's
``quantum_machine_learning``, ``quantum_spintronics`` and
``QuantumValidationFramework``, which import its ``quantum`` package) is
not ported yet.
"""

from .sweeps import parameter_ladder_sweep, switching_probability_diagram
from .benchmarking import (
    BenchmarkResult,
    BenchmarkSuite,
    bootstrap_ci,
    compare_policies,
    create_standard_benchmark_suite,
    significance_test,
)
from .optimizers import (
    OptimizationResult,
    cross_entropy,
    grid_search,
    optimize_switching_pulse,
    simulated_annealing,
    switching_objective,
)
from .comparative_algorithms import (
    ComparativeAnalysis,
    OptimalControlBaseline,
    PhysicsInformedRL,
    run_comprehensive_benchmark,
)
from .novel_algorithms import (
    AdaptiveMetaLearner,
    Hypothesis,
    HypothesisDrivenExperimentEngine,
    QuantumInspiredSpintronicOptimizer,
)
from .publication_framework import FigureGenerator, PublicationFramework, StatisticalAnalyzer
from .validation_framework import ResearchValidationFramework, ValidationCheck

__all__ = [
    "parameter_ladder_sweep",
    "switching_probability_diagram",
    "BenchmarkResult",
    "BenchmarkSuite",
    "bootstrap_ci",
    "compare_policies",
    "create_standard_benchmark_suite",
    "significance_test",
    "OptimizationResult",
    "cross_entropy",
    "grid_search",
    "optimize_switching_pulse",
    "simulated_annealing",
    "switching_objective",
    "ComparativeAnalysis",
    "OptimalControlBaseline",
    "PhysicsInformedRL",
    "run_comprehensive_benchmark",
    "AdaptiveMetaLearner",
    "Hypothesis",
    "HypothesisDrivenExperimentEngine",
    "QuantumInspiredSpintronicOptimizer",
    "FigureGenerator",
    "PublicationFramework",
    "StatisticalAnalyzer",
    "ResearchValidationFramework",
    "ValidationCheck",
]
