"""Hierarchical configuration system.

The port's own copy of ``spintorque_tpu/config.py``, which is numpy-free
Python: a dataclass tree with precedence defaults < file (YAML/JSON) <
SPIN_TORQUE_* environment variables, validation and module-global
accessors. The fields are the JAX package's, unchanged; ``ComputeConfig``'s
mesh fields describe a ``parallel.make_mesh``. ``ConfigManager.make_env``
builds the port's ``SpinTorqueEnv``, on the card unless the caller asks
for the CPU, or on a mesh.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


@dataclass
class PhysicsConfig:
    method: str = "rk4"  # 'euler' | 'rk4' | 'heun'
    max_step: float = 1e-12
    max_substeps: int = 0  # 0 -> derived from max pulse duration
    include_thermal: bool = True
    noise_mode: str = "reference"  # 'reference' | 'physical'
    # 'per_substep' (physically correct, default) | 'per_stage' (reference
    # sampling; deflates per-substep field variance to 10/36 - see
    # envs/spin_torque.py SpinTorqueEnvConfig.rk4_noise)
    rk4_noise: str = "per_substep"
    temperature: float = 300.0


@dataclass
class DeviceConfig:
    device_type: str = "stt_mram"
    parameters: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EnvironmentConfig:
    max_steps: int = 100
    max_current: float = 2e6
    max_duration: float = 5e-9
    action_mode: str = "continuous"
    observation_mode: str = "vector"
    success_threshold: float = 0.9
    energy_penalty_weight: float = 0.1
    batch_size: int = 4096
    autoreset: bool = True


@dataclass
class TrainingConfig:
    algorithm: str = "ppo"
    total_timesteps: int = 1_000_000
    learning_rate: float = 3e-4
    rollout_steps: int = 16
    num_epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    seed: int = 0
    hidden_sizes: Tuple[int, ...] = (256, 256)


@dataclass
class ComputeConfig:
    dtype: str = "float32"
    mesh_data: int = 0  # 0 -> all devices
    mesh_model: int = 1
    distributed: bool = False
    coordinator_address: Optional[str] = None


@dataclass
class LoggingConfig:
    level: str = "INFO"
    log_dir: str = "logs"
    structured: bool = False  # JSON log lines
    metrics_interval: int = 10


@dataclass
class SpinTorqueConfig:
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    environment: EnvironmentConfig = field(default_factory=EnvironmentConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    debug_mode: bool = False
    strict_mode: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


# SPIN_TORQUE_* env var -> (section, field, type) mapping, mirroring the
# reference's ~35 mappings (config.py:155-212) where they still apply.
_ENV_MAPPINGS = {
    "SPIN_TORQUE_DEVICE_TYPE": ("device", "device_type", str),
    "SPIN_TORQUE_MAX_STEPS": ("environment", "max_steps", int),
    "SPIN_TORQUE_MAX_CURRENT": ("environment", "max_current", float),
    "SPIN_TORQUE_MAX_DURATION": ("environment", "max_duration", float),
    "SPIN_TORQUE_ACTION_MODE": ("environment", "action_mode", str),
    "SPIN_TORQUE_OBSERVATION_MODE": ("environment", "observation_mode", str),
    "SPIN_TORQUE_SUCCESS_THRESHOLD": ("environment", "success_threshold", float),
    "SPIN_TORQUE_BATCH_SIZE": ("environment", "batch_size", int),
    "SPIN_TORQUE_TEMPERATURE": ("physics", "temperature", float),
    "SPIN_TORQUE_METHOD": ("physics", "method", str),
    "SPIN_TORQUE_INCLUDE_THERMAL": ("physics", "include_thermal", bool),
    "SPIN_TORQUE_NOISE_MODE": ("physics", "noise_mode", str),
    "SPIN_TORQUE_RK4_NOISE": ("physics", "rk4_noise", str),
    "SPIN_TORQUE_LEARNING_RATE": ("training", "learning_rate", float),
    "SPIN_TORQUE_TOTAL_TIMESTEPS": ("training", "total_timesteps", int),
    "SPIN_TORQUE_SEED": ("training", "seed", int),
    "SPIN_TORQUE_DTYPE": ("compute", "dtype", str),
    "SPIN_TORQUE_MESH_DATA": ("compute", "mesh_data", int),
    "SPIN_TORQUE_MESH_MODEL": ("compute", "mesh_model", int),
    "SPIN_TORQUE_LOG_LEVEL": ("logging", "level", str),
    "SPIN_TORQUE_LOG_DIR": ("logging", "log_dir", str),
    "SPIN_TORQUE_DEBUG": (None, "debug_mode", bool),
    "SPIN_TORQUE_STRICT": (None, "strict_mode", bool),
}


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


class ConfigManager:
    """Merges defaults <- config file <- environment variables
    (precedence per config.py:124-137)."""

    def __init__(self, config_file: Optional[str] = None):
        self.config = SpinTorqueConfig()
        if config_file:
            self.load_file(config_file)
        self.apply_env_overrides()
        self.validate()

    def load_file(self, path: str | Path) -> None:
        path = Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            try:
                import yaml  # type: ignore

                data = yaml.safe_load(text)
            except ImportError:
                raise ImportError(
                    "pyyaml is required for YAML configs; use JSON instead"
                )
        else:
            data = json.loads(text)
        self._merge(data or {})

    def _merge(self, data: Dict[str, Any]) -> None:
        for section, values in data.items():
            if not hasattr(self.config, section):
                raise ValueError(f"Unknown config section: {section}")
            target = getattr(self.config, section)
            if isinstance(values, dict) and hasattr(target, "__dataclass_fields__"):
                for k, v in values.items():
                    if not hasattr(target, k):
                        raise ValueError(f"Unknown config field: {section}.{k}")
                    setattr(target, k, v)
            else:
                setattr(self.config, section, values)

    def apply_env_overrides(self) -> None:
        for var, (section, fieldname, typ) in _ENV_MAPPINGS.items():
            raw = os.environ.get(var)
            if raw is None:
                continue
            value = _parse_bool(raw) if typ is bool else typ(raw)
            if section is None:
                setattr(self.config, fieldname, value)
            else:
                setattr(getattr(self.config, section), fieldname, value)

    def validate(self) -> None:
        c = self.config
        if c.environment.max_steps <= 0:
            raise ValueError("max_steps must be positive")
        if c.environment.max_current <= 0:
            raise ValueError("max_current must be positive")
        if not 0 < c.environment.success_threshold <= 1:
            raise ValueError("success_threshold must be in (0, 1]")
        if c.physics.temperature < 0:
            raise ValueError("temperature must be non-negative")
        if c.physics.method not in ("euler", "rk4", "heun"):
            raise ValueError(f"Unknown integration method: {c.physics.method}")
        if c.physics.noise_mode not in ("reference", "physical"):
            raise ValueError(f"Unknown noise mode: {c.physics.noise_mode}")
        if c.physics.rk4_noise not in ("per_stage", "per_substep"):
            raise ValueError(f"Unknown rk4_noise: {c.physics.rk4_noise}")
        if c.compute.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"Unsupported dtype: {c.compute.dtype}")

    def save(self, path: str | Path) -> None:
        path = Path(path)
        data = self.config.to_dict()
        if path.suffix in (".yaml", ".yml"):
            import yaml  # type: ignore

            path.write_text(yaml.safe_dump(data))
        else:
            path.write_text(json.dumps(data, indent=2, default=str))

    # ---- env/trainer construction from config ----

    def make_env(self, device=None, mesh=None):
        """The configured ``SpinTorqueEnv`` on ``device`` ("cuda" unless the
        caller asks for "cpu"), or sharded over ``mesh`` (a
        ``parallel.Mesh``: the batch size is then the global one, and the
        env runs on the mesh's device)."""
        from .envs import SpinTorqueEnv, SpinTorqueEnvConfig

        c = self.config
        cfg = SpinTorqueEnvConfig(
            device_type=c.device.device_type,
            max_steps=c.environment.max_steps,
            max_current=c.environment.max_current,
            max_duration=c.environment.max_duration,
            temperature=c.physics.temperature,
            include_thermal=c.physics.include_thermal,
            action_mode=c.environment.action_mode,
            observation_mode=c.environment.observation_mode,
            success_threshold=c.environment.success_threshold,
            energy_penalty_weight=c.environment.energy_penalty_weight,
            method=c.physics.method,
            max_substeps=c.physics.max_substeps,
            noise_mode=c.physics.noise_mode,
            rk4_noise=c.physics.rk4_noise,
            autoreset=c.environment.autoreset,
            dtype=c.compute.dtype,
        )
        return SpinTorqueEnv(
            device_params=c.device.parameters or None,
            batch_size=c.environment.batch_size,
            config=cfg,
            device=device,
            mesh=mesh,
        )


_global_config: Optional[ConfigManager] = None


def get_config() -> SpinTorqueConfig:
    global _global_config
    if _global_config is None:
        _global_config = ConfigManager()
    return _global_config.config


def get_config_manager() -> ConfigManager:
    global _global_config
    if _global_config is None:
        _global_config = ConfigManager()
    return _global_config


def update_config(data: Dict[str, Any]) -> None:
    get_config_manager()._merge(data)
    get_config_manager().validate()


def reset_config() -> None:
    global _global_config
    _global_config = None
