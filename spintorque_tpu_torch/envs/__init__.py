"""RL environments: the vectorized functional envs and their Gymnasium
adapters.

PyTorch counterpart of ``spintorque_tpu/envs``. The adapters and wrappers
need gymnasium; without it they are None and the functional envs work.
"""

from .array import (
    ArrayEnvConfig,
    ArrayEnvState,
    ArrayTimeStep,
    SpinTorqueArrayEnv,
    checkerboard_pattern,
    coupling_matrix,
)
from .skyrmion import (
    SkyrmionEnvConfig,
    SkyrmionEnvState,
    SkyrmionRacetrackEnv,
    SkyrmionTimeStep,
)
from .spin_torque import EnvState, SpinTorqueEnv, SpinTorqueEnvConfig, TimeStep

try:
    from .gym_adapter import (
        GymSkyrmionRacetrackEnv,
        GymSpinTorqueArrayEnv,
        GymSpinTorqueEnv,
        VectorSpinTorqueEnv,
    )
    from .wrappers import EpisodeStatisticsWrapper, RobustEnvironmentWrapper
except ImportError:  # gymnasium unavailable
    GymSpinTorqueEnv = None
    GymSpinTorqueArrayEnv = None
    GymSkyrmionRacetrackEnv = None
    VectorSpinTorqueEnv = None
    RobustEnvironmentWrapper = None
    EpisodeStatisticsWrapper = None

__all__ = [
    "EnvState",
    "SpinTorqueEnv",
    "SpinTorqueEnvConfig",
    "TimeStep",
    "ArrayEnvConfig",
    "ArrayEnvState",
    "ArrayTimeStep",
    "SpinTorqueArrayEnv",
    "checkerboard_pattern",
    "coupling_matrix",
    "SkyrmionEnvConfig",
    "SkyrmionEnvState",
    "SkyrmionRacetrackEnv",
    "SkyrmionTimeStep",
    "GymSpinTorqueEnv",
    "GymSpinTorqueArrayEnv",
    "GymSkyrmionRacetrackEnv",
    "VectorSpinTorqueEnv",
    "RobustEnvironmentWrapper",
    "EpisodeStatisticsWrapper",
]
