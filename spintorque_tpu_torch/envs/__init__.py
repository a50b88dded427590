"""RL environments: the vectorized SpinTorque-v0 core.

PyTorch counterpart of ``spintorque_tpu/envs``; the array and skyrmion envs
and the Gymnasium adapters are not ported yet.
"""

from .spin_torque import EnvState, SpinTorqueEnv, SpinTorqueEnvConfig, TimeStep

__all__ = ["EnvState", "SpinTorqueEnv", "SpinTorqueEnvConfig", "TimeStep"]
