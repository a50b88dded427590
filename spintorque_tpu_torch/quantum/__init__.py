"""Quantum add-on tier: state-vector simulation, QAOA/VQE optimizers,
surface-code error correction, hybrid scheduling, benchmark/verification.

PyTorch counterpart of ``spintorque_tpu/quantum``, with the same 23 names.
Everything here runs as batch programs on the entry point's device (the
card unless the caller asks for "cpu"): gates are float32 matmuls over a
batch of real-pair state vectors, Monte-Carlo error trials are GF(2)
products over a batch of trials, variational optimizers take exact
autograd gradients, and the hybrid paths' classical halves are pulses of
the pulse kernel (K1) on the card. None of these products is a TPU kernel
of the JAX package: they are the plain XLA products it computes outside
its Pallas kernel. ``advantage_verification`` is the honest statistical
harness for making performance claims.
"""

from .advantage_verification import (
    AdvantageReport,
    PerformanceAnalytics,
    QuantumAdvantageVerifier,
)
from .benchmarking import (
    QuantumBenchmarkSuite,
    create_standard_benchmark_suite,
)
from .circuits import CircuitOptimizer, Gate, HardwareCompiler, QuantumCircuit
from .energy_landscape import QuantumEnhancedEnergyLandscape, SymmetryEnhancedVQE
from .error_correction import (
    LogicalQubitOperations,
    SkyrmionErrorCorrection,
    SurfaceCodeErrorCorrection,
    TopologicalProtection,
)
from .hybrid_computing import (
    AdaptiveResourceOptimizer,
    AdaptiveScheduler,
    HybridMultiDeviceSimulator,
    ProgrammableQuantumSimulator,
    SimulationTask,
)
from .optimization import (
    IterationFreeQAOA,
    OptimizationResult,
    QuantumMLDeviceOptimizer,
)

__all__ = [
    "AdvantageReport",
    "PerformanceAnalytics",
    "QuantumAdvantageVerifier",
    "QuantumBenchmarkSuite",
    "create_standard_benchmark_suite",
    "CircuitOptimizer",
    "Gate",
    "HardwareCompiler",
    "QuantumCircuit",
    "QuantumEnhancedEnergyLandscape",
    "SymmetryEnhancedVQE",
    "LogicalQubitOperations",
    "SkyrmionErrorCorrection",
    "SurfaceCodeErrorCorrection",
    "TopologicalProtection",
    "AdaptiveResourceOptimizer",
    "AdaptiveScheduler",
    "HybridMultiDeviceSimulator",
    "ProgrammableQuantumSimulator",
    "SimulationTask",
    "IterationFreeQAOA",
    "OptimizationResult",
    "QuantumMLDeviceOptimizer",
]
