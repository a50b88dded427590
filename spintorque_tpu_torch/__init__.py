"""spintorque_tpu_torch: the PyTorch + CUDA port of spintorque_tpu.

The vectorized SpinTorque-v0 environment step - action decode, the masked
LLGS pulse integration (a hand-written CUDA kernel for Hopper on the GPU,
its plain PyTorch version on the CPU), energy, observation, composite reward
and auto-reset - over a batch of independent spintronic devices. The JAX
package ``spintorque_tpu`` is the reference it is tested against.
"""

__version__ = "0.5.0"

# ``ops`` before ``physics``: ops.cuda_integrator imports physics.integrator,
# which imports ops.philox.
from . import constants, ops  # noqa: I001
from . import devices, physics, rewards
from .devices import DeviceParams, make_device_params
from .envs import EnvState, SpinTorqueEnv, SpinTorqueEnvConfig, TimeStep
from .physics import IntegratorConfig, LLGSParams, integrate_pulse
from .rewards import CompositeReward
from .utils import measure_env_throughput

__all__ = [
    "constants",
    "devices",
    "ops",
    "physics",
    "rewards",
    "DeviceParams",
    "make_device_params",
    "EnvState",
    "SpinTorqueEnv",
    "SpinTorqueEnvConfig",
    "TimeStep",
    "IntegratorConfig",
    "LLGSParams",
    "integrate_pulse",
    "CompositeReward",
    "measure_env_throughput",
    "__version__",
]
