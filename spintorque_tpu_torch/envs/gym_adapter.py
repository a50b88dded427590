"""Gymnasium adapters over the functional vectorized environments.

PyTorch counterpart of ``spintorque_tpu/envs/gym_adapter.py``. The
functional envs are the fast path: batched, resident on their device.
These adapters give them the Gymnasium surface for host-loop RL libraries:

  * GymSpinTorqueEnv        - single-env gymnasium.Env over SpinTorqueEnv (B=1)
  * VectorSpinTorqueEnv     - batched numpy in/out over SpinTorqueEnv
  * GymSpinTorqueArrayEnv   - single-env adapter of SpinTorqueArrayEnv
  * GymSkyrmionRacetrackEnv - single-env adapter of SkyrmionRacetrackEnv

Each takes ``device=`` (the card unless the caller passes "cpu") and a
``dtype`` that defaults to float32 on every device: the pulse kernel is
float32 only. Each reset draws the functional env's seed from a seed
sequence the adapter owns, restarted by ``reset(seed=...)``. A step moves
its outputs to the host once (``utils.host.to_host``: one wait for all of
them), then converts them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError as e:  # pragma: no cover
    raise ImportError("gymnasium is required for the Gym adapters") from e

from ..utils.host import next_seed, to_host
from .spin_torque import SpinTorqueEnv, SpinTorqueEnvConfig


def _warn_ignored_kwargs(cls_name: str, extra: dict) -> None:
    """The adapters tolerate unknown constructor kwargs (gym.make merges the
    registration's kwargs with the user's), but warn: a misspelled or
    unrouted knob would otherwise quietly run the default physics."""
    if extra:
        import warnings

        warnings.warn(
            f"{cls_name}: ignoring unknown constructor kwargs "
            f"{sorted(extra)} (unrecognized by this environment)",
            stacklevel=3,
        )


def _dtype(dtype: Optional[str]) -> str:
    """The adapters' float dtype: float32 unless the caller asks."""
    return "float32" if dtype is None else dtype


def _seed_sequence(seed: Optional[int]) -> np.random.SeedSequence:
    return np.random.SeedSequence(0 if seed is None else seed)


def _make_spaces(env: SpinTorqueEnv):
    """Spaces in the env's float dtype: a space that claims float32 over
    float64 observations fails gymnasium's env checker on dtype."""
    cfg = env.config
    f_dtype = np.dtype(cfg.dtype)
    if cfg.action_mode == "continuous":
        action_space = spaces.Box(
            low=np.array([-cfg.max_current, 0.0], dtype=f_dtype),
            high=np.array([cfg.max_current, cfg.max_duration], dtype=f_dtype),
            dtype=f_dtype,
        )
    else:
        action_space = spaces.Discrete(env.num_actions)

    if cfg.observation_mode == "vector":
        observation_space = spaces.Box(
            low=-np.inf, high=np.inf, shape=(12,), dtype=f_dtype
        )
    else:
        # Unit-vector bounds widened by a float epsilon: renormalized
        # components can land a few ulps outside [-1, 1].
        unit = 1.0 + 1e-5
        observation_space = spaces.Dict(
            {
                "magnetization": spaces.Box(-unit, unit, shape=(3,), dtype=f_dtype),
                "target": spaces.Box(-unit, unit, shape=(3,), dtype=f_dtype),
                "resistance": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                "temperature": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                "steps_remaining": spaces.Box(
                    0, cfg.max_steps, shape=(1,), dtype=np.int32
                ),
                "energy_consumed": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                "last_action": spaces.Box(-np.inf, np.inf, shape=(2,), dtype=f_dtype),
            }
        )
    return action_space, observation_space


def _to_numpy_obs(obs, squeeze: bool, space=None):
    """Host observations (numpy, from ``to_host``) in the declared space
    dtype, without the batch axis when ``squeeze``."""
    if isinstance(obs, dict):
        out = {}
        for k, v in obs.items():
            arr = np.asarray(v)
            if space is not None and k in space.spaces:
                arr = arr.astype(space.spaces[k].dtype, copy=False)
            out[k] = arr
        if squeeze:
            out = {k: v[0] for k, v in out.items()}
        return out
    arr = np.asarray(obs)
    if space is not None:
        arr = arr.astype(space.dtype, copy=False)
    return arr[0] if squeeze else arr


def _scalar_info(info: Dict[str, Any], idx: Optional[int] = None) -> Dict[str, Any]:
    """Host info (numpy, from ``to_host``) without the reward breakdown;
    env ``idx``'s entries, as Python scalars where 0-dim."""
    out = {}
    for k, v in info.items():
        if k in ("reward_components",):
            continue
        arr = np.asarray(v)
        if idx is not None and arr.ndim >= 1:
            arr = arr[idx]
        out[k] = arr.item() if arr.ndim == 0 and arr.size == 1 else arr
    return out


def _batched(action) -> np.ndarray:
    """One env's action with a batch axis of 1."""
    if np.isscalar(action) or (isinstance(action, np.ndarray) and action.ndim == 0):
        return np.asarray([action])
    return np.asarray(action)[None, ...]


def _single_step(adapter, action):
    """Steps a single-env adapter's functional env and reads the step back
    in one wait; returns the gymnasium step tuple and the batched action."""
    if adapter._state is None:
        raise RuntimeError("Environment must be reset before calling step")
    batched = _batched(action)
    adapter._state, ts = adapter._env.step(adapter._state, batched)
    host = to_host(ts)
    out = (
        _to_numpy_obs(host.obs, squeeze=True, space=adapter.observation_space),
        float(host.reward[0]),
        bool(host.terminated[0]),
        bool(host.truncated[0]),
        _scalar_info(host.info, idx=0),
    )
    return out, batched


class GymSpinTorqueEnv(gym.Env):
    """Single-environment Gymnasium adapter of SpinTorqueEnv."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(
        self,
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_states: Optional[List[np.ndarray]] = None,
        max_steps: int = 100,
        max_current: float = 2e6,
        max_duration: float = 5e-9,
        temperature: float = 300.0,
        include_thermal_fluctuations: bool = True,
        reward_components: Optional[Dict[str, Dict]] = None,
        action_mode: str = "continuous",
        observation_mode: str = "vector",
        success_threshold: float = 0.9,
        energy_penalty_weight: float = 0.1,
        render_mode: Optional[str] = None,
        seed: Optional[int] = None,
        batch_size: int = 1,
        dtype: str | None = None,
        # Integrator knobs beyond the reference surface, routed explicitly
        # so that ``extra`` cannot swallow them. None = not supplied: only
        # values the caller gives are forwarded, so SpinTorqueEnvConfig
        # stays the one source of defaults.
        method: str | None = None,
        max_substeps: int | None = None,
        noise_mode: str | None = None,
        rk4_noise: str | None = None,
        bf16_rhs: bool | None = None,
        device=None,
        **extra,
    ):
        _warn_ignored_kwargs("GymSpinTorqueEnv", extra)
        del batch_size  # accepted, as in the JAX package; the adapter runs one env
        super().__init__()
        self._ctor = dict(
            device_type=device_type,
            device_params=device_params,
            target_states=target_states,
            reward_components=reward_components,
            device=device,
        )
        self._cfg_kwargs = dict(
            max_steps=max_steps,
            max_current=max_current,
            max_duration=max_duration,
            temperature=temperature,
            include_thermal=include_thermal_fluctuations,
            action_mode=action_mode,
            observation_mode=observation_mode,
            success_threshold=success_threshold,
            energy_penalty_weight=energy_penalty_weight,
            autoreset=False,
            dtype=_dtype(dtype),
        )
        self._cfg_kwargs.update({
            k: v for k, v in dict(
                method=method, max_substeps=max_substeps, noise_mode=noise_mode,
                rk4_noise=rk4_noise, bf16_rhs=bf16_rhs,
            ).items() if v is not None
        })
        self._build_env()
        self.render_mode = render_mode
        self.action_space, self.observation_space = _make_spaces(self._env)
        self._seeds = _seed_sequence(seed)
        self._state = None
        self.episode_history: List[Dict[str, Any]] = []

    def _build_env(self):
        c = self._ctor
        cfg = SpinTorqueEnvConfig(device_type=c["device_type"], **self._cfg_kwargs)
        self._env = SpinTorqueEnv(
            device_type=c["device_type"], device_params=c["device_params"],
            target_states=c["target_states"], batch_size=1,
            reward_components=c["reward_components"], config=cfg, device=c["device"],
        )

    @property
    def device_type(self) -> str:
        return self._env.config.device_type

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        # Seeds gymnasium's np_random too (the env checker and some wrappers
        # expect it); the env's own draws come from the seed sequence.
        super().reset(seed=seed)
        if seed is not None:
            self._seeds = _seed_sequence(seed)
        options = options or {}
        if "temperature" in options:
            self._cfg_kwargs["temperature"] = float(options["temperature"])
            self._build_env()
        state, _ = self._env.reset(next_seed(self._seeds))
        dtype, device = self._env.config.torch_dtype, self._env.device
        if "initial_state" in options:
            m = np.asarray(options["initial_state"], float)
            m = m / np.linalg.norm(m)
            state = dataclasses.replace(
                state, m=torch.as_tensor(m, dtype=dtype, device=device)[None]
            )
        if "target_state" in options:
            t = np.asarray(options["target_state"], float)
            t = t / np.linalg.norm(t)
            state = dataclasses.replace(
                state, target=torch.as_tensor(t, dtype=dtype, device=device)[None]
            )
        self._state = state
        self.episode_history = []
        host = to_host({"obs": self._env.observe(state), "m": state.m, "target": state.target})
        info = {
            "step_count": 0,
            "total_energy": 0.0,
            "current_alignment": float(np.sum(host["m"][0] * host["target"][0])),
        }
        return _to_numpy_obs(host["obs"], squeeze=True, space=self.observation_space), info

    def step(self, action):
        out, batched = _single_step(self, action)
        info = out[4]
        self.episode_history.append(
            {
                "step": info.get("step_count"),
                "action": batched[0],
                "magnetization": info["final_magnetization"].copy(),
                "reward": out[1],
                "energy": info.get("step_energy"),
                "alignment": info.get("current_alignment"),
            }
        )
        return out

    def analyze_episode(self) -> Dict[str, Any]:
        """Episode summary."""
        if not self.episode_history:
            return {}
        total_energy = sum(h["energy"] for h in self.episode_history)
        final_alignment = self.episode_history[-1]["alignment"]
        success = final_alignment >= self._env.config.success_threshold
        switching_step = next(
            (
                i + 1
                for i, h in enumerate(self.episode_history)
                if h["alignment"] >= self._env.config.success_threshold
            ),
            None,
        )
        return {
            "episode_length": len(self.episode_history),
            "total_energy": total_energy,
            "final_alignment": final_alignment,
            "success": success,
            "switching_step": switching_step,
            "average_reward": float(np.mean([h["reward"] for h in self.episode_history])),
            "energy_efficiency": final_alignment / total_energy if total_energy > 0 else 0,
            "history": list(self.episode_history),
        }

    def get_device_info(self) -> Dict[str, Any]:
        from ..devices import device_factory

        return device_factory.create_device(
            self._env.config.device_type, self._ctor["device_params"], device=self._env.device
        ).get_device_info()

    def get_health_report(self) -> Dict[str, Any]:
        from ..utils.monitoring import default_health_monitor

        report = default_health_monitor(self._env.device).run()
        report["episode_steps"] = len(self.episode_history)
        return report

    def get_solver_info(self) -> Dict[str, Any]:
        cfg = self._env.config
        return {
            "method": cfg.method,
            "max_substeps": cfg.resolved_max_substeps(),
            "device": str(self._env.device),
            "thermal": cfg.include_thermal,
            "noise_mode": cfg.noise_mode,
            "rk4_noise": cfg.rk4_noise,
            "bf16_rhs": cfg.bf16_rhs,
            "dtype": cfg.dtype,
        }

    def get_performance_stats(self) -> Dict[str, Any]:
        """``devices`` follows the env's device: the CUDA count on a card,
        1 on the CPU (as ``deployment.server`` reports it)."""
        dev = self._env.device
        return {
            "solver": self.get_solver_info(),
            "health": self.get_health_report(),
            "backend": dev.type,
            "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        }

    def render(self):  # pragma: no cover - optional visualization
        if self.render_mode is None:
            return None
        from ..utils.rendering import render_spin_torque

        return render_spin_torque(self, mode=self.render_mode)

    def close(self):
        pass


class VectorSpinTorqueEnv(gym.Env):
    """Batched adapter: numpy in/out over the functional env (B > 1).

    Follows the gymnax auto-reset convention: when an env is done, the
    returned observation is the reset observation and
    info['final_observation'] holds the terminal one. Its spaces are one
    env's, ``single_action_space`` and ``single_observation_space``, as in
    the JAX package (it is a ``gymnasium.Env``, not a ``VectorEnv``).
    """

    def __init__(
        self,
        num_envs: int = 4096,
        seed: Optional[int] = None,
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_states: Optional[List[np.ndarray]] = None,
        reward_components: Optional[Dict[str, Dict]] = None,
        include_thermal_fluctuations: bool = True,
        device=None,
        **cfg_kwargs,
    ):
        self.num_envs = num_envs
        cfg = SpinTorqueEnvConfig(
            device_type=device_type,
            include_thermal=include_thermal_fluctuations,
            autoreset=True,
            **cfg_kwargs,
        )
        self._env = SpinTorqueEnv(
            device_type=device_type,
            device_params=device_params,
            target_states=target_states,
            batch_size=num_envs,
            reward_components=reward_components,
            config=cfg,
            device=device,
        )
        self.single_action_space, self.single_observation_space = _make_spaces(self._env)
        self._seeds = _seed_sequence(seed)
        self._state = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._seeds = _seed_sequence(seed)
        self._state, obs = self._env.reset(next_seed(self._seeds))
        return _to_numpy_obs(to_host(obs), squeeze=False, space=self.single_observation_space), {}

    def step(self, actions):
        self._state, ts = self._env.step(self._state, np.asarray(actions))
        host = to_host(ts)
        return (
            _to_numpy_obs(host.obs, squeeze=False, space=self.single_observation_space),
            host.reward,
            host.terminated,
            host.truncated,
            _scalar_info(host.info),
        )

    @property
    def functional_env(self) -> SpinTorqueEnv:
        return self._env

    def close(self):
        pass


class GymSpinTorqueArrayEnv(gym.Env):
    """Single-environment Gymnasium adapter of the crossbar array env."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        array_size=(4, 4),
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_pattern=None,
        max_steps: int = 200,
        max_current: float = 2e6,
        max_duration: float = 5e-9,
        temperature: float = 300.0,
        include_thermal_fluctuations: bool = True,
        include_coupling: bool = True,
        coupling_strength: float = 0.1,
        coupling_type: str = "dipolar",
        coupling_update: str = "sequential",
        reward_components: Optional[Dict[str, Dict]] = None,
        action_mode: str = "individual",
        observation_mode: str = "array",
        success_threshold: float = 0.9,
        energy_penalty_weight: float = 0.1,
        render_mode: Optional[str] = None,
        seed: Optional[int] = None,
        dtype: str | None = None,
        device=None,
        **extra,
    ):
        from .array import ArrayEnvConfig, SpinTorqueArrayEnv

        _warn_ignored_kwargs("GymSpinTorqueArrayEnv", extra)
        super().__init__()
        del include_thermal_fluctuations  # accepted and unused, as in the reference
        cfg = ArrayEnvConfig(
            rows=array_size[0], cols=array_size[1], device_type=device_type,
            max_steps=max_steps, max_current=max_current,
            max_duration=max_duration, temperature=temperature,
            include_coupling=include_coupling,
            coupling_strength=coupling_strength, coupling_type=coupling_type,
            coupling_update=coupling_update,
            action_mode=action_mode, observation_mode=observation_mode,
            success_threshold=success_threshold,
            energy_penalty_weight=energy_penalty_weight,
            autoreset=False, dtype=_dtype(dtype),
        )
        self._env = SpinTorqueArrayEnv(
            device_params=device_params, target_pattern=target_pattern,
            batch_size=1, reward_components=reward_components, config=cfg, device=device,
        )
        self.render_mode = render_mode
        self._setup_spaces()
        self._seeds = _seed_sequence(seed)
        self._state = None
        self.n_rows, self.n_cols = cfg.rows, cfg.cols
        self.n_devices = cfg.n_devices

    def _setup_spaces(self):
        # In the env's float dtype, like _make_spaces.
        cfg = self._env.config
        f_dtype = np.dtype(cfg.dtype)
        N, R, C = cfg.n_devices, cfg.rows, cfg.cols
        hi0 = {"individual": N - 1, "row": R - 1, "column": C - 1}.get(cfg.action_mode)
        if hi0 is None:  # global
            self.action_space = spaces.Box(
                low=np.array([-cfg.max_current, 0.0], f_dtype),
                high=np.array([cfg.max_current, cfg.max_duration], f_dtype),
                dtype=f_dtype,
            )
        else:
            self.action_space = spaces.Box(
                low=np.array([0, -cfg.max_current, 0.0], f_dtype),
                high=np.array([hi0, cfg.max_current, cfg.max_duration], f_dtype),
                dtype=f_dtype,
            )
        unit = 1.0 + 1e-5  # renormalized components can sit a few ulps out
        if cfg.observation_mode == "array":
            self.observation_space = spaces.Box(
                low=-unit, high=unit, shape=(R, C, 6), dtype=f_dtype
            )
        elif cfg.observation_mode == "vector":
            self.observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(N * 6 + 4,), dtype=f_dtype
            )
        else:
            self.observation_space = spaces.Dict(
                {
                    "current_pattern": spaces.Box(-unit, unit, shape=(R, C, 3), dtype=f_dtype),
                    "target_pattern": spaces.Box(-unit, unit, shape=(R, C, 3), dtype=f_dtype),
                    # The mean alignment with the target ranges over [-1, 1].
                    "pattern_similarity": spaces.Box(-unit, unit, shape=(1,), dtype=f_dtype),
                    "steps_remaining": spaces.Box(0, cfg.max_steps, shape=(1,), dtype=np.int32),
                    "total_energy": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                }
            )

    def _pattern(self, pattern) -> torch.Tensor:
        cfg = self._env.config
        p = np.asarray(pattern, float).reshape(cfg.n_devices, 3)
        return torch.as_tensor(p, dtype=cfg.torch_dtype, device=self._env.device)[None]

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._seeds = _seed_sequence(seed)
        options = options or {}
        state, _ = self._env.reset(next_seed(self._seeds))
        if "initial_pattern" in options:
            state = dataclasses.replace(state, pattern=self._pattern(options["initial_pattern"]))
        if "target_pattern" in options:
            state = dataclasses.replace(state, target=self._pattern(options["target_pattern"]))
        self._state = state
        obs = to_host(self._env.observe(state))
        return _to_numpy_obs(obs, squeeze=True, space=self.observation_space), {"step_count": 0}

    def step(self, action):
        return _single_step(self, action)[0]

    def set_target_pattern(self, pattern):
        target = self._pattern(pattern)
        if self._state is not None:
            self._state = dataclasses.replace(self._state, target=target)

    def close(self):
        pass


class GymSkyrmionRacetrackEnv(gym.Env):
    """Single-environment Gymnasium adapter of the skyrmion racetrack env."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 20}

    def __init__(
        self,
        track_length: float = 1000e-9,
        track_width: float = 200e-9,
        track_thickness: float = 2e-9,
        n_skyrmions: int = 1,
        skyrmion_radius: float = 20e-9,
        target_positions=None,
        max_steps: int = 150,
        max_current: float = 1e12,
        max_gradient: float = 1e18,
        temperature: float = 300.0,
        include_thermal_fluctuations: bool = True,
        include_pinning: bool = True,
        pinning_strength: float = 0.1,
        reward_components: Optional[Dict[str, Dict]] = None,
        action_mode: str = "continuous",
        observation_mode: str = "vector",
        success_threshold: float = 10e-9,
        energy_penalty_weight: float = 0.1,
        render_mode: Optional[str] = None,
        seed: Optional[int] = None,
        dtype: str | None = None,
        device=None,
        **extra,
    ):
        from .skyrmion import SkyrmionEnvConfig, SkyrmionRacetrackEnv

        _warn_ignored_kwargs("GymSkyrmionRacetrackEnv", extra)
        super().__init__()
        cfg = SkyrmionEnvConfig(
            track_length=track_length, track_width=track_width,
            track_thickness=track_thickness, n_skyrmions=n_skyrmions,
            skyrmion_radius=skyrmion_radius, max_steps=max_steps,
            max_current=max_current, max_gradient=max_gradient,
            temperature=temperature,
            include_thermal=include_thermal_fluctuations,
            include_pinning=include_pinning, pinning_strength=pinning_strength,
            action_mode=action_mode, observation_mode=observation_mode,
            success_threshold=success_threshold,
            energy_penalty_weight=energy_penalty_weight,
            autoreset=False, dtype=_dtype(dtype),
        )
        self._env = SkyrmionRacetrackEnv(
            target_positions=target_positions, batch_size=1,
            reward_components=reward_components, config=cfg,
            seed=0 if seed is None else seed, device=device,
        )
        self.render_mode = render_mode
        self._setup_spaces()
        self._seeds = _seed_sequence(seed)
        self._state = None
        self.n_skyrmions = n_skyrmions
        self.track_length = track_length

    def _setup_spaces(self):
        # In the env's float dtype, like _make_spaces.
        cfg = self._env.config
        f_dtype = np.dtype(cfg.dtype)
        n = cfg.n_skyrmions
        if cfg.action_mode == "continuous":
            self.action_space = spaces.Box(
                low=np.array(
                    [-cfg.max_current, -cfg.max_current,
                     -cfg.max_gradient, -cfg.max_gradient, 0.0], f_dtype
                ),
                high=np.array(
                    [cfg.max_current, cfg.max_current,
                     cfg.max_gradient, cfg.max_gradient, 2e-9], f_dtype
                ),
                dtype=f_dtype,
            )
        else:
            self.action_space = spaces.Discrete(self._env.num_actions)
        if cfg.observation_mode == "vector":
            obs_size = n * 4 + n * 2 + 4
            self.observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(obs_size,), dtype=f_dtype
            )
        else:
            self.observation_space = spaces.Dict(
                {
                    "positions": spaces.Box(0, cfg.track_length, shape=(n, 2), dtype=f_dtype),
                    "velocities": spaces.Box(-np.inf, np.inf, shape=(n, 2), dtype=f_dtype),
                    "target_positions": spaces.Box(0, cfg.track_length, shape=(n,), dtype=f_dtype),
                    "position_errors": spaces.Box(0, np.inf, shape=(n,), dtype=f_dtype),
                    "steps_remaining": spaces.Box(0, cfg.max_steps, shape=(1,), dtype=np.int32),
                    "total_energy": spaces.Box(0, np.inf, shape=(1,), dtype=f_dtype),
                }
            )

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._seeds = _seed_sequence(seed)
        options = options or {}
        state, _ = self._env.reset(next_seed(self._seeds))
        cfg = self._env.config
        if "initial_positions" in options:
            p = np.asarray(options["initial_positions"], float)
            state = dataclasses.replace(state, positions=torch.as_tensor(
                p, dtype=cfg.torch_dtype, device=self._env.device)[None])
        if "target_positions" in options:
            self._env.set_targets(options["target_positions"])
        self._state = state
        obs = to_host(self._env.observe(state))
        return _to_numpy_obs(obs, squeeze=True, space=self.observation_space), {"step_count": 0}

    def step(self, action):
        return _single_step(self, action)[0]

    def close(self):
        pass
