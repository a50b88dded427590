"""Vectorized SpinTorque environment (SpinTorque-v0) in PyTorch.

Counterpart of ``spintorque_tpu/envs/spin_torque.py``. One step runs, over a
batch of B independent devices: action decode with the safety clamps, the
masked LLGS pulse (``physics.integrator.integrate_pulse``: the CUDA kernel
on a CUDA device, its plain version on the CPU), the energy at the pre-step
resistance, the 12-dim observation, the composite reward, termination and
auto-reset.

On CUDA the step reads nothing back from the device: constants live on the
device from construction, and every draw of a step is keyed on the host
from the state's seed and step counter: the pulse's Philox key is
derive_seed(seed, counter), and the auto-reset states come from a
torch.Generator on the device seeded from the same pair under a stream tag
of its own (``ops.philox.step_generator``). A step is therefore a function
of its state: stepping one state twice gives the same outputs and next
states, bit for bit.

On CUDA ``step`` replays one captured CUDA graph of the eager step body
(``envs.step_graph``), which gives the same bits; the CPU steps eagerly.
With tracing on, every step records the span ``spin_torque.step``; a replay
records ``spin_torque.replay`` under it, and an eager step the pulse's spans
(``integrator.pulse`` and, on CUDA, ``cuda_integrator.*``).

On a mesh (``mesh=``, ``parallel.make_mesh``) ``batch_size`` stays the global
B and each rank holds its B/W rows: the pulse runs on the rank's shard (K5
on CUDA) with the shard's global env indices in the thermal stream, and
reset and auto-reset draw the global batch from the seed and keep the
rank's rows. A sharded step therefore equals the one-process step bit for
bit, thermal noise and auto-reset included. A B that does not divide the
data axis is replicated, as the JAX package runs such a batch: every rank
holds all B rows and steps them as one process does (the unsharded
kernel, K1 on CUDA), so its step equals the one-process step on every
rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..devices import DeviceParams, make_device_params
from ..devices.resistance import pulse_energy as _pulse_energy
from ..devices.resistance import resistance as _resistance
from ..ops.cuda_integrator import cuda_kernel_available, cuda_supported, is_plus_z
from ..ops.philox import RESET_STREAM, as_int64, derive_seed, step_generator, step_seed
from ..parallel.mesh import local_rows, replicates, resolve_device, split_mesh
from ..physics.integrator import (
    IntegratorConfig,
    check_config,
    integrate_pulse,
    max_substeps_for,
)
from ..rewards import CompositeReward, RewardContext, RunningStat, default_reward_config
from ..utils.profiling import counter, span
from .step_graph import GraphHook, StepGraphs

Tensor = torch.Tensor

# Every SpinTorqueEnv.step call of the process, and of them the captures,
# the replays and the eager steps on the card (``envs.step_graph``).
ENV_STEPS = counter("env.steps")
GRAPH_CAPTURES = counter("env.graph_captures")
GRAPH_REPLAYS = counter("env.graph_replays")
EAGER_STEPS = counter("env.eager_steps")


def _graph_keys(thermal: bool, autoreset: bool, device):
    """One captured step's keys (``GraphHook.keys``): the pulse's Philox
    key, a 0-dim device tensor the kernel reads, and the auto-reset
    generator; and the function that sets them from a state in stream
    order, the key filled on the device and the generator's seed (its
    offset back to 0), which the replay copies to the device."""
    key = torch.zeros((), dtype=torch.int64, device=device)
    generator = torch.Generator(device=device)

    def set_keys(state) -> None:
        if thermal:
            key.fill_(as_int64(derive_seed(state.seed, state.counter)))
        if autoreset:
            generator.manual_seed(step_seed(state.seed, state.counter, RESET_STREAM))

    return (key, generator), set_keys


class SpinTorqueEnvConfig(NamedTuple):
    """Static environment configuration."""

    device_type: str = "stt_mram"
    max_steps: int = 100
    max_current: float = 2e6  # A/m^2
    max_duration: float = 5e-9  # s
    temperature: float = 300.0  # K
    include_thermal: bool = True
    action_mode: str = "continuous"  # 'continuous' | 'discrete'
    observation_mode: str = "vector"  # 'vector' | 'dict'
    success_threshold: float = 0.9
    energy_penalty_weight: float = 0.1
    method: str = "rk4"
    max_substeps: int = 0  # 0 -> derived from max_duration
    noise_mode: str = "reference"
    # RK4 thermal-field sampling. The env's default is 'per_substep', one
    # field realization over the four stages; the library-level
    # IntegratorConfig default stays 'per_stage' (the reference's sampling).
    rk4_noise: str = "per_substep"
    autoreset: bool = True
    dtype: str = "float32"
    # bf16 stage arithmetic in the pulse integrator (K6 on CUDA; the plain
    # bf16 version on the CPU, where the JAX package computes float32).
    bf16_rhs: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def resolved_max_substeps(self) -> int:
        if self.max_substeps:
            return self.max_substeps
        return max_substeps_for(self.max_duration)

    def integrator(self) -> IntegratorConfig:
        return IntegratorConfig(
            method=self.method,
            max_step=1e-12,
            max_substeps=self.resolved_max_substeps(),
            thermal=self.include_thermal,
            noise_mode=self.noise_mode,
            rk4_noise=self.rk4_noise,
            bf16_rhs=self.bf16_rhs,
        )


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Batched environment state.

    ``seed`` and ``counter`` live on the host and key every draw of step
    ``counter``: its thermal noise by derive_seed(seed, counter), its
    auto-reset states by ``step_generator(seed, counter, RESET_STREAM)``.
    The state holds no generator, so nothing in it advances in place.
    """

    m: Tensor  # (B, 3) magnetization
    target: Tensor  # (B, 3)
    step: Tensor  # (B,) int32
    total_energy: Tensor  # (B,)
    last_current: Tensor  # (B,)
    last_duration: Tensor  # (B,)
    episode_return: Tensor  # (B,) running sum of rewards
    seed: int  # 64-bit base key of every draw of a step
    counter: int  # steps taken since reset
    reward_stats: Dict[str, RunningStat] = dataclasses.field(default_factory=dict)


class TimeStep(NamedTuple):
    obs: Any  # (B, obs_dim) or dict of tensors
    reward: Any  # (B,)
    terminated: Any  # (B,) bool
    truncated: Any  # (B,) bool
    info: Dict[str, Any]


# Discrete action tables: 5 currents x 4 durations.
_N_DURATIONS = 4
_DURATION_LEVELS = (0.1e-9, 0.5e-9, 1.0e-9, 2.0e-9)
_N_CURRENTS = 5


class SpinTorqueEnv:
    """Vectorized spin-torque device control environment.

    Usage:
        env = SpinTorqueEnv(batch_size=4096)
        state, obs = env.reset(seed=0)
        state, ts = env.step(state, actions)

    ``device`` is "cuda" unless the caller asks for "cpu" (or the mesh's
    device when ``mesh`` is given). On "cuda" the
    configuration must be one the kernel covers (float32, a known method, a
    finite nonzero easy axis), and construction builds the kernel library
    and probes it; both raise on failure, as does the lack of a card.
    ``bf16_rhs=True`` launches the kernel's bf16 variant (K6) on CUDA and
    runs its plain bf16 version on the CPU.

    ``mesh`` (a ``parallel.Mesh``) shards the env: ``batch_size`` is the
    global B, the env runs on the mesh's device, and states, observations
    and actions hold this rank's ``local_batch_size`` rows: B / W, or all B
    where B does not divide the data axis (``replicated``).
    """

    def __init__(
        self,
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_states: Optional[List[np.ndarray]] = None,
        batch_size: int = 1,
        reward_components: Optional[Dict[str, Dict]] = None,
        config: Optional[SpinTorqueEnvConfig] = None,
        *,
        device=None,
        mesh=None,
        **config_overrides,
    ):
        if config is None:
            config = SpinTorqueEnvConfig(device_type=device_type, **config_overrides)
        self.config = config
        self.batch_size = batch_size
        self.device = resolve_device(device, mesh)
        self.mesh = mesh
        # Whether every rank holds the whole batch (parallel.replicates).
        self.replicated = replicates(batch_size, mesh)
        self._split_mesh = split_mesh(batch_size, mesh)
        self._local_rows = local_rows(batch_size, mesh)
        self.local_batch_size = self._local_rows.stop - self._local_rows.start
        dtype = config.torch_dtype
        # Raised by every setter of what a captured step bakes in.
        self._graph_version = 0

        if target_states is None:
            targets = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
        else:
            targets = np.stack([np.asarray(t, float) for t in target_states])
            targets = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
        self.target_states = torch.as_tensor(targets, dtype=dtype, device=self.device)  # (K, 3)
        self._current_levels = torch.linspace(
            -config.max_current, config.max_current, _N_CURRENTS, dtype=dtype, device=self.device
        )
        self._duration_levels = torch.as_tensor(_DURATION_LEVELS, dtype=dtype, device=self.device)

        self._integrator = config.integrator()
        check_config(self._integrator)
        self.device_params = make_device_params(
            config.device_type, device_params, dtype=dtype, device=self.device
        )
        if self.device.type == "cuda" and not cuda_kernel_available():
            raise RuntimeError("no CUDA device for the CUDA pulse kernel")

        if reward_components is None:
            reward_components = default_reward_config(
                config.energy_penalty_weight, config.observation_mode
            )
        self.reward = CompositeReward(reward_components)
        self._graphs = StepGraphs(self) if self.device.type == "cuda" else None

    @property
    def device_params(self) -> DeviceParams:
        return self._device_params

    @device_params.setter
    def device_params(self, params: DeviceParams) -> None:
        """Every later step integrates with ``params``: per-env fields (domain
        randomization) may replace the constructed ones, as in the JAX env.
        On "cuda" the kernel must cover them."""
        llgs = params.llgs()
        cfg = self.config
        if self.device.type == "cuda" and not cuda_supported(llgs, self._integrator,
                                                             cfg.torch_dtype):
            raise ValueError(
                f"the CUDA pulse kernel does not cover method={cfg.method!r}, "
                f"dtype={cfg.dtype!r} with this easy axis"
            )
        self._device_params = params
        # Resolved once here: deciding per step would read the axis back.
        self._llgs = dataclasses.replace(llgs, plus_z=is_plus_z(llgs.easy_axis))
        self._graph_version += 1

    @property
    def target_states(self) -> Tensor:
        """The (K, 3) unit targets the reset draws from."""
        return self._target_states

    @target_states.setter
    def target_states(self, targets: Tensor) -> None:
        self._target_states = targets
        self._graph_version += 1

    def graph_version(self):
        """The version of what a captured step bakes in as a tensor address
        or a Python number: raised by the ``device_params`` and
        ``target_states`` setters, and the reward's (``CompositeReward``,
        its ``version``); part of the captured steps' key."""
        return (self._graph_version, self.reward, self.reward.version)

    def _graph_hook(self) -> GraphHook:
        """What the captured step of ``envs.step_graph`` needs of this env:
        its device, local batch and mesh split, the span
        ``spin_torque.replay``, the ``env.*`` counters, and its keys (the
        pulse's and the auto-reset's)."""
        mesh = self._split_mesh
        cfg = self.config
        return GraphHook(
            static_key=(str(self.device), self.local_batch_size,
                        None if mesh is None else (mesh.shape["data"], mesh.data_rank)),
            span="spin_torque.replay", captures=GRAPH_CAPTURES, replays=GRAPH_REPLAYS,
            eager_steps=EAGER_STEPS,
            keys=functools.partial(_graph_keys, cfg.include_thermal, cfg.autoreset))

    # ------------------------------------------------------------------ API

    def reset(self, seed: int) -> Tuple[EnvState, Any]:
        """A fresh batch; ``seed`` seeds the generator of the reset draws and
        keys every later step's draws."""
        dtype = self.config.torch_dtype
        B = self.local_batch_size
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        stats = (
            self.reward.init_stats(B, dtype, device=self.device) if self.reward.needs_stats else {}
        )

        def zeros():
            return torch.zeros((B,), dtype=dtype, device=self.device)

        state = EnvState(
            m=self._sample_m(generator),
            target=self._sample_target(generator),
            step=torch.zeros((B,), dtype=torch.int32, device=self.device),
            total_energy=zeros(),
            last_current=zeros(),
            last_duration=zeros(),
            episode_return=zeros(),
            seed=seed,
            counter=0,
            reward_stats=stats,
        )
        return state, self.observe(state)

    @property
    def observation_size(self) -> int:
        return 12

    @property
    def action_size(self) -> int:
        return 2 if self.config.action_mode == "continuous" else 1

    @property
    def num_actions(self) -> int:
        return _N_CURRENTS * _N_DURATIONS

    # ------------------------------------------------------------- internals

    def _rows(self, x: Tensor) -> Tensor:
        """This rank's rows of a global batch draw (all of it without a
        mesh): every rank draws the whole batch from the same key, as the
        one-process env does."""
        return x if self.mesh is None else x[self._local_rows]

    def _sample_m(self, generator) -> Tensor:
        """Random initial magnetization: normal(0, 1, 3) normalized."""
        m = torch.randn((self.batch_size, 3), generator=generator, dtype=self.config.torch_dtype,
                        device=self.device)
        norm = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
        return self._rows(m / torch.clamp_min(norm, 1e-12))

    def _sample_target(self, generator) -> Tensor:
        idx = torch.randint(
            0, self.target_states.shape[0], (self.batch_size,), generator=generator,
            device=self.device,
        )
        return self.target_states[self._rows(idx)]

    def _action_tensor(self, action) -> Tensor:
        """The action as a tensor on the env's device (a copy from the host
        for a numpy array), in the configuration's dtype for continuous
        actions, a single env's [current, duration] pair as one row."""
        cfg = self.config
        if cfg.action_mode != "continuous":
            return torch.as_tensor(action, device=self.device)
        action = torch.as_tensor(action, dtype=cfg.torch_dtype, device=self.device)
        if action.ndim == 1 and self.local_batch_size == 1 and action.shape[0] == 2:
            # A single env given the documented [current, duration] pair.
            action = action[None, :]
        if action.ndim == 1 and action.shape[0] != self.local_batch_size:
            raise ValueError(
                f"1-D continuous action of length {action.shape[0]} does "
                f"not match the batch of {self.local_batch_size} envs; pass "
                "(B, 2) [current, duration] actions"
            )
        return action

    def _decode_action(self, action) -> Tuple[Tensor, Tensor]:
        """Action -> (J, duration) with the safety clamps."""
        cfg = self.config
        action = self._action_tensor(action)
        if cfg.action_mode == "continuous":
            if action.ndim == 1:  # (B,) current-only -> default 1 ns
                current = action
                duration = torch.full_like(current, 1e-9)
            else:
                current = action[..., 0]
                duration = action[..., 1]
            # NaN/Inf scrub: invalid -> (0, 1e-12).
            bad = ~(torch.isfinite(current) & torch.isfinite(duration))
            current = torch.where(bad, 0.0, current)
            duration = torch.where(bad, 1e-12, duration)
        else:
            idx = action.to(torch.int32).reshape(-1)
            current_idx = torch.clamp(idx // _N_DURATIONS, 0, _N_CURRENTS - 1)
            duration_idx = torch.clamp(idx % _N_DURATIONS, 0, _N_DURATIONS - 1)
            current = self._current_levels[current_idx.long()]
            duration = self._duration_levels[duration_idx.long()]
        current = torch.clamp(current, -cfg.max_current, cfg.max_current)
        duration = torch.clamp(duration, 1e-12, cfg.max_duration)
        return current, duration

    def _resistance(self, m: Tensor) -> Tensor:
        return _resistance(
            self.config.device_type, m[..., 0], m[..., 1], m[..., 2], self.device_params
        )

    def observe(self, state: EnvState):
        """Observation of a state: 12-dim vector or dict."""
        cfg = self.config
        dtype = cfg.torch_dtype
        r = self._resistance(state.m)
        if cfg.observation_mode == "vector":
            r0 = self.device_params.resistance_parallel
            # In float32 and then cast, as the JAX package computes it there
            # (its int32 / int is float32 even with 64-bit types enabled).
            steps_left = ((cfg.max_steps - state.step).float() / cfg.max_steps).to(dtype)
            return torch.cat(
                [
                    state.m,
                    state.target,
                    (r / r0)[..., None],
                    torch.full_like(r, cfg.temperature / 300.0)[..., None],
                    steps_left[..., None],
                    (state.total_energy / 1e-12)[..., None],
                    (state.last_current / cfg.max_current)[..., None],
                    (state.last_duration / cfg.max_duration)[..., None],
                ],
                dim=-1,
            )
        return {
            "magnetization": state.m,
            "target": state.target,
            "resistance": r[..., None],
            "temperature": torch.full_like(r, cfg.temperature)[..., None],
            "steps_remaining": (cfg.max_steps - state.step)[..., None],
            "energy_consumed": state.total_energy[..., None],
            "last_action": torch.stack([state.last_current, state.last_duration], -1),
        }

    def step(self, state: EnvState, action) -> Tuple[EnvState, TimeStep]:
        """One step of every env: (next state, TimeStep). On CUDA a replay
        of the captured step (``envs.step_graph``); eager on the CPU, inside
        another capture, and for an action that requires grad (which the
        pulse kernel refuses)."""
        ENV_STEPS.add()
        with span("spin_torque.step"):
            if (self._graphs is None or torch.cuda.is_current_stream_capturing()
                    or getattr(action, "requires_grad", False)):
                EAGER_STEPS.add()
                return self._step(state, action)
            return self._graphs.step(self, state, action)

    def _step(self, state: EnvState, action, key=None, generator=None):
        """The eager step body: (next state, TimeStep). Its draws are keyed
        by the state's (seed, counter), unless a captured step passes its own
        ``key`` (the pulse's, a device tensor) and ``generator`` (the
        auto-reset draws'), which it sets to the same values before each
        replay."""
        cfg = self.config
        B = self.local_batch_size

        current, duration = self._decode_action(action)

        m_prev = state.m
        prev_alignment = torch.sum(m_prev * state.target, dim=-1)

        # --- dynamics: one pulse integration over the batch ---
        mx0, my0, mz0 = m_prev.t().contiguous().unbind(0)
        res = integrate_pulse(
            (mx0, my0, mz0),
            span=duration,
            current=current,
            params=self._llgs,
            config=self._integrator,
            seed=derive_seed(state.seed, state.counter) if key is None else key,
            temperature=cfg.temperature,
            mesh=self._split_mesh,
        )
        mx, my, mz = res.m
        # Final renormalization...
        norm = torch.sqrt(mx * mx + my * my + mz * mz)
        m_int = torch.stack([mx / norm, my / norm, mz / norm], dim=-1)
        # ...unless the solve failed (a zero row), in which case the
        # reference keeps the pre-step state untouched, not renormalized.
        m_new = torch.where(res.failed[:, None], m_prev, m_int)

        # --- energy at the PRE-step resistance ---
        r_pre = self._resistance(m_prev)
        step_energy = _pulse_energy(current, duration, r_pre, self.device_params.area)
        total_energy = state.total_energy + step_energy
        step = state.step + 1

        alignment = torch.sum(m_new * state.target, dim=-1)
        improvement = alignment - prev_alignment
        is_success = alignment >= cfg.success_threshold

        terminated = is_success
        truncated = step >= cfg.max_steps
        done = terminated | truncated

        mid_state = dataclasses.replace(
            state,
            m=m_new,
            step=step,
            total_energy=total_energy,
            last_current=current,
            last_duration=duration,
            counter=state.counter + 1,
        )
        obs_step = self.observe(mid_state)

        m_norm = torch.linalg.vector_norm(m_new, dim=-1)
        ctx = RewardContext(
            is_success=is_success,
            step_energy=step_energy,
            alignment=alignment,
            alignment_improvement=improvement,
            magnetization_norm=m_norm,
            step_count=step,
            total_energy=total_energy,
            action_current=current,
            action_duration=duration,
        )
        reward, breakdown, new_stats = self.reward.compute(ctx, state.reward_stats)
        # Safety reward clamp.
        reward = torch.clamp(torch.nan_to_num(reward, nan=-1.0), -1e6, 1e6)
        episode_return = state.episode_return + reward

        info: Dict[str, Any] = {
            "step_count": step,
            "total_energy": total_energy,
            "current_alignment": alignment,
            "is_success": is_success,
            "target_reached": is_success,
            "step_energy": step_energy,
            "alignment_improvement": improvement,
            "pulse_duration": duration,
            "current_density": current,
            "magnetization_magnitude": m_norm,
            "episode_return": episode_return,
            "reward_components": breakdown,
            "final_magnetization": m_new,
            "simulation_success": ~res.failed,
        }

        if cfg.autoreset:
            # Done envs are reset on the device, by selects.
            if generator is None:
                generator = step_generator(state.seed, state.counter, RESET_STREAM, self.device)
            m_reset = self._sample_m(generator)
            t_reset = self._sample_target(generator)
            d3 = done[:, None]
            next_state = dataclasses.replace(
                mid_state,
                m=torch.where(d3, m_reset, m_new),
                target=torch.where(d3, t_reset, state.target),
                step=torch.where(done, 0, step),
                total_energy=torch.where(done, 0.0, total_energy),
                last_current=torch.where(done, 0.0, current),
                last_duration=torch.where(done, 0.0, duration),
                episode_return=torch.where(done, 0.0, episode_return),
                reward_stats=new_stats,
            )
            obs_reset = self.observe(next_state)
            if cfg.observation_mode == "vector":
                obs = torch.where(d3, obs_reset, obs_step)
            else:
                obs = {
                    k: torch.where(done.reshape((B,) + (1,) * (v.ndim - 1)), v, obs_step[k])
                    for k, v in obs_reset.items()
                }
            info["final_observation"] = obs_step
        else:
            next_state = dataclasses.replace(
                mid_state, episode_return=episode_return, reward_stats=new_stats
            )
            obs = obs_step

        return next_state, TimeStep(
            obs=obs,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info=info,
        )
