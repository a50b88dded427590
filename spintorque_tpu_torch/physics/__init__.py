"""Physics: batched LLGS dynamics, the pulse integrator, the solver
facades, adaptive integration, thermal models, energy landscapes and
materials.

PyTorch counterpart of ``spintorque_tpu/physics``, with the same names.
"""

from .integrator import (
    IntegratorConfig,
    PulseResult,
    integrate_pulse,
    integrate_pulse_plain,
    integrate_pulse_trajectory,
    max_substeps_for,
    substep_counts,
)
from .llgs import (
    LLGSParams,
    dmdt,
    effective_field,
    energy_density,
    normalize_with_fallback,
    thermal_field_strength,
)
from .adaptive import (
    AdaptiveResult,
    find_stable_states,
    integrate_adaptive,
    llgs_solver_rhs,
    trajectory_energy,
    trajectory_torques,
)
from .energy_landscape import EnergyLandscape
from .materials import MaterialDatabase, MaterialProperties
from .solver import (
    AdaptiveLLGSSolver,
    LLGSSolver,
    RobustLLGSSolver,
    ScalableLLGSSolver,
    SimpleLLGSSolver,
    params_from_dict,
)
from .thermal import ThermalFluctuations
from .vector_ops import (
    batch_anisotropy_field,
    batch_cross,
    batch_demag_field_thin_film,
    batch_dot,
    batch_magnetic_energy,
    batch_normalize,
    batch_tmr_resistance,
)

__all__ = [
    "IntegratorConfig",
    "PulseResult",
    "integrate_pulse",
    "integrate_pulse_plain",
    "integrate_pulse_trajectory",
    "max_substeps_for",
    "substep_counts",
    "LLGSParams",
    "dmdt",
    "effective_field",
    "energy_density",
    "normalize_with_fallback",
    "thermal_field_strength",
    "MaterialDatabase",
    "MaterialProperties",
    "LLGSSolver",
    "AdaptiveLLGSSolver",
    "SimpleLLGSSolver",
    "RobustLLGSSolver",
    "ScalableLLGSSolver",
    "params_from_dict",
    "ThermalFluctuations",
    "EnergyLandscape",
    "AdaptiveResult",
    "llgs_solver_rhs",
    "integrate_adaptive",
    "find_stable_states",
    "trajectory_energy",
    "trajectory_torques",
    "batch_cross",
    "batch_dot",
    "batch_normalize",
    "batch_magnetic_energy",
    "batch_tmr_resistance",
    "batch_anisotropy_field",
    "batch_demag_field_thin_film",
]
