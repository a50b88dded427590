"""Hand-written CUDA kernels for Hopper and the Philox stream they draw from.

``philox`` is imported first: ``physics.integrator`` needs it, and
``cuda_integrator`` needs ``physics.integrator``. ``op_chain`` is the
per-op price micro-benchmark (K7).
"""

from . import philox
from .cuda_integrator import (
    PROBE_LAUNCHES,
    PULSE_BF16_LAUNCHES,
    PULSE_LAUNCHES,
    PULSE_SHARDED_LAUNCHES,
    cuda_kernel_available,
    cuda_supported,
    integrate_pulse_cuda,
    shard_env_offset,
)
from . import op_chain  # noqa: E402

__all__ = [
    "philox",
    "op_chain",
    "PROBE_LAUNCHES",
    "PULSE_BF16_LAUNCHES",
    "PULSE_LAUNCHES",
    "PULSE_SHARDED_LAUNCHES",
    "cuda_kernel_available",
    "cuda_supported",
    "integrate_pulse_cuda",
    "shard_env_offset",
]
