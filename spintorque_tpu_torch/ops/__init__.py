"""Hand-written CUDA kernels for Hopper and the Philox stream they draw from.

``philox`` is imported first: ``physics.integrator`` needs it, and
``cuda_integrator`` needs ``physics.integrator``.
"""

from . import philox
from .cuda_integrator import (
    PROBE_LAUNCHES,
    PULSE_BF16_LAUNCHES,
    PULSE_LAUNCHES,
    cuda_kernel_available,
    cuda_supported,
    integrate_pulse_cuda,
)

__all__ = [
    "philox",
    "PROBE_LAUNCHES",
    "PULSE_BF16_LAUNCHES",
    "PULSE_LAUNCHES",
    "cuda_kernel_available",
    "cuda_supported",
    "integrate_pulse_cuda",
]
