"""spintorque_tpu_torch: the PyTorch + CUDA port of spintorque_tpu.

The vectorized SpinTorque-v0 environment step - action decode, the masked
LLGS pulse integration (a hand-written CUDA kernel for Hopper on the GPU,
float32 or with bf16 stage arithmetic, its plain PyTorch version on the
CPU), energy, observation, composite reward and auto-reset - over a batch
of independent spintronic devices, the PPO trainer on top of it, the
data-parallel path over torch.distributed (``parallel``: each rank holds
its rows of the batch and runs the pulse kernel on them), the switching /
parameter-ladder sweeps (``research``), the crossbar array and skyrmion
racetrack envs, the device factory and its analytics (``devices``), and
the Gymnasium adapters; the analysis physics (the solver facades
``LLGSSolver`` and ``AdaptiveLLGSSolver``, trajectories, adaptive RK45,
midpoint and Radau integration, thermal analytics, energy landscapes,
materials) and the shell (``config``, ``utils.checkpoint``,
``utils.profiling``). The JAX package ``spintorque_tpu`` is the reference it
is tested against.

Importing the package registers the Gymnasium ids
``spintorque_torch/SpinTorque-v0``, ``spintorque_torch/SpinTorqueArray-v0``
and ``spintorque_torch/SkyrmionRacetrack-v0`` when gymnasium is installed
(``registration``); the bare ids are the JAX package's.
"""

__version__ = "0.5.0"

# ``ops`` before ``physics``: ops.cuda_integrator imports physics.integrator,
# which imports ops.philox.
from . import constants, ops  # noqa: I001
from . import devices, parallel, physics, research, rewards, rl
from .devices import DeviceFactory, DeviceParams, create_device, make_device_params
from .envs import (
    EnvState,
    SkyrmionRacetrackEnv,
    SpinTorqueArrayEnv,
    SpinTorqueEnv,
    SpinTorqueEnvConfig,
    TimeStep,
)
from .physics import (
    IntegratorConfig,
    LLGSParams,
    LLGSSolver,
    MaterialDatabase,
    SimpleLLGSSolver,
    ThermalFluctuations,
    integrate_pulse,
)
from .rewards import CompositeReward
from .rl import ActorCritic, PPOConfig, PPOTrainer
from .utils import measure_env_throughput, measure_train_throughput

# Gymnasium is an interop dependency, not a core one: the functional envs
# work without it.
try:
    from .registration import register_envs

    register_envs()
except ImportError:  # gymnasium unavailable
    pass

__all__ = [
    "constants",
    "devices",
    "ops",
    "parallel",
    "physics",
    "research",
    "rewards",
    "rl",
    "DeviceFactory",
    "DeviceParams",
    "create_device",
    "make_device_params",
    "EnvState",
    "SkyrmionRacetrackEnv",
    "SpinTorqueArrayEnv",
    "SpinTorqueEnv",
    "SpinTorqueEnvConfig",
    "TimeStep",
    "IntegratorConfig",
    "LLGSParams",
    "LLGSSolver",
    "SimpleLLGSSolver",
    "MaterialDatabase",
    "ThermalFluctuations",
    "integrate_pulse",
    "CompositeReward",
    "ActorCritic",
    "PPOConfig",
    "PPOTrainer",
    "measure_env_throughput",
    "measure_train_throughput",
    "__version__",
]
