"""Physics: batched LLGS dynamics and the pulse integrator.

PyTorch counterpart of ``spintorque_tpu/physics``; only the modules the
vectorized env step reads are ported so far.
"""

from .integrator import (
    IntegratorConfig,
    PulseResult,
    integrate_pulse,
    integrate_pulse_plain,
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

__all__ = [
    "IntegratorConfig",
    "PulseResult",
    "integrate_pulse",
    "integrate_pulse_plain",
    "max_substeps_for",
    "substep_counts",
    "LLGSParams",
    "dmdt",
    "effective_field",
    "energy_density",
    "normalize_with_fallback",
    "thermal_field_strength",
]
