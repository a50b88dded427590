"""Research tooling: parameter optimization, benchmarking, validation.

PyTorch counterpart of ``spintorque_tpu/research``: the mesh-sharded
switching and parameter sweeps, population optimizers whose population is
one pulse-kernel launch, the benchmark suite and policy comparison,
gradient optimal control and the comparative analysis, the meta-learner,
annealer and hypothesis engine, the publication framework, the validation
checks, and the quantum half over ``spintorque_tpu_torch.quantum``:
variational QML models, the QAOA device-design optimizer and its
benchmark, and the quantum tier's validation checks.
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
from .quantum_machine_learning import (
    QuantumNeuralNetwork,
    QuantumReinforcementLearning,
    QuantumSpinOptimizer,
)
from .quantum_spintronics import QuantumSpintronicBenchmark, QuantumSpintronicOptimizer
from .validation_framework import (
    QuantumValidationFramework,
    ResearchValidationFramework,
    ValidationCheck,
)

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
    "QuantumNeuralNetwork",
    "QuantumReinforcementLearning",
    "QuantumSpinOptimizer",
    "QuantumSpintronicBenchmark",
    "QuantumSpintronicOptimizer",
    "QuantumValidationFramework",
    "ResearchValidationFramework",
    "ValidationCheck",
]
