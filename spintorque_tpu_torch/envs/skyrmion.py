"""Vectorized skyrmion racetrack environment (SkyrmionRacetrack-v0) in
PyTorch.

Counterpart of ``spintorque_tpu/envs/skyrmion.py``. A batch of B
racetracks, each carrying n point-particle skyrmions, advances together;
the per-skyrmion force assembly and the 10-substep damped-inertia Euler
with reflecting walls are (B, n, 2) tensor ops. The reference's semantics
are kept: a fixed 20 degree Hall angle, drive force = SHA |J| with the
Magnus force tan(20 deg) times it across, gradient forces scaled by 1e-24,
exponential pinning wells along the centerline, a thermal kick of
sqrt(2 k_B T / (r 1e-9)) in a random direction per step, wall clipping
with the velocity reflected at -0.5x, stability exp(-|v| / 50) and a
resistive pulse energy.

The pinning sites are drawn at construction from
``np.random.default_rng(seed)`` with the JAX package's calls, so both
packages hold the same sites. The reset draws come from a torch.Generator
seeded with the reset seed; step k's thermal kicks and auto-reset draws
from generators on the env's device seeded from the state's (seed, k),
each under a stream tag of its own (``ops.philox.step_seed``, derived in
``_graph_keys``). The state holds no generator, so a step is a function of
its state.

On CUDA ``step`` replays one captured CUDA graph of the eager step body
``_step`` (``envs.step_graph``), which gives the same bits; the CPU steps
eagerly. With tracing on, every step records the span ``racetrack.step``;
a replay records ``racetrack.replay`` under it, and an eager step (a
capture's warm-up, the CPU's) its phases, ``racetrack.decode``,
``.forces``, ``.substeps``, ``.reward``, ``.observe`` and ``.reset``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import KB_SOLVER
from ..ops.philox import KICK_STREAM, RESET_STREAM, step_seed
from ..parallel.mesh import resolve_device
from ..rewards import CompositeReward, RewardContext, RunningStat
from ..utils.profiling import counter, span
from .step_graph import GraphHook, StepGraphs

Tensor = torch.Tensor

_HALL_ANGLE = math.radians(20.0)

# Host counters, counted whatever the tracing switch: steps, and of them the
# captures, the replays and the eager steps on the card (``envs.step_graph``).
RACETRACK_STEPS = counter("racetrack.steps")
GRAPH_CAPTURES = counter("racetrack.graph_captures")
GRAPH_REPLAYS = counter("racetrack.graph_replays")
EAGER_STEPS = counter("racetrack.eager_steps")


class SkyrmionEnvConfig(NamedTuple):
    """Static configuration."""

    track_length: float = 1000e-9
    track_width: float = 200e-9
    track_thickness: float = 2e-9
    n_skyrmions: int = 1
    skyrmion_radius: float = 20e-9
    max_steps: int = 150
    max_current: float = 1e12
    max_gradient: float = 1e18
    temperature: float = 300.0
    include_thermal: bool = True
    include_pinning: bool = True
    pinning_strength: float = 0.1
    action_mode: str = "continuous"  # 'continuous' | 'discrete'
    observation_mode: str = "vector"  # 'vector' | 'dict'
    success_threshold: float = 10e-9
    energy_penalty_weight: float = 0.1
    autoreset: bool = True
    dtype: str = "float32"
    # Racetrack material
    saturation_magnetization: float = 580e3
    damping: float = 0.3
    spin_hall_angle: float = 0.1
    resistivity: float = 2e-7

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class SkyrmionEnvState:
    positions: Tensor  # (B, n, 2)
    velocities: Tensor  # (B, n, 2)
    step: Tensor  # (B,) int32
    total_energy: Tensor  # (B,)
    episode_return: Tensor  # (B,)
    seed: int  # the reset seed; with counter, the key of a step's draws
    counter: int  # steps taken since reset
    reward_stats: Dict[str, RunningStat] = dataclasses.field(default_factory=dict)


class SkyrmionTimeStep(NamedTuple):
    obs: Any
    reward: Any
    terminated: Any
    truncated: Any
    info: Dict[str, Any]


# Discrete action tables: 5 directions x 3 gradients x 3 durations.
_DIRECTIONS = np.array([[1, 0], [-1, 0], [0, 1], [0, -1], [0, 0]], float)
_N_GRADIENTS = 3
_N_DURATIONS = 3
_DURATION_LEVELS = (0.1e-9, 0.5e-9, 1.0e-9)


def _default_reward_config(cfg: SkyrmionEnvConfig) -> Dict[str, Dict]:
    def positioning(ctx: RewardContext):
        errors = ctx.extras["position_errors"]  # (B, n)
        per = torch.where(
            errors < cfg.success_threshold,
            10.0,
            torch.clamp_min(5.0 * (1.0 - errors / (cfg.track_length * 0.1)), 0.0),
        )
        return per.mean(-1)

    def energy(ctx: RewardContext):
        return -ctx.step_energy / 1e-15  # fJ

    def velocity(ctx: RewardContext):
        vmag = ctx.extras["velocity_magnitudes"]  # (B, n)
        return torch.where(vmag > 100.0, (vmag - 100.0) / 100.0, 0.0).sum(-1)

    def stability(ctx: RewardContext):
        return ctx.extras["stability_factors"].mean(-1)

    def efficiency(ctx: RewardContext):
        disp = ctx.extras["total_displacement"]
        e = ctx.step_energy
        eff = torch.clamp_max(disp / (e / 1e-15), 10.0)
        return torch.where(e > 0, eff, 0.0)

    return {
        "positioning": {"weight": 10.0, "function": positioning},
        "energy": {"weight": -cfg.energy_penalty_weight, "function": energy},
        "velocity": {"weight": -1.0, "function": velocity},
        "stability": {"weight": 5.0, "function": stability},
        "efficiency": {"weight": 2.0, "function": efficiency},
    }


def _norm(v: Tensor, keepdim: bool = False) -> Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def _graph_keys(include_thermal: bool, autoreset: bool, device):
    """A step's keys (``GraphHook.keys``): the generators of its thermal
    kicks and of its auto-reset, and the function that seeds them from a
    state (their offsets back to 0), each from the state's (seed, counter)
    under its stream tag. The eager step takes its generators from here too."""
    kick = torch.Generator(device=device)
    reset = torch.Generator(device=device)

    def set_keys(state) -> None:
        if include_thermal:
            kick.manual_seed(step_seed(state.seed, state.counter, KICK_STREAM))
        if autoreset:
            reset.manual_seed(step_seed(state.seed, state.counter, RESET_STREAM))

    return (kick, reset), set_keys


class SkyrmionRacetrackEnv:
    """Vectorized skyrmion racetrack environment (functional API).

    Usage:
        env = SkyrmionRacetrackEnv(batch_size=4096)
        state, obs = env.reset(seed=0)
        state, ts = env.step(state, actions)  # (B, 5) [Jx, Jy, gx, gy, t]

    ``device`` is "cuda" unless the caller asks for "cpu"; ``seed`` draws
    the pinning sites.
    """

    def __init__(
        self,
        target_positions: Optional[List[float]] = None,
        batch_size: int = 1,
        reward_components: Optional[Dict[str, Dict]] = None,
        config: Optional[SkyrmionEnvConfig] = None,
        seed: int = 0,
        *,
        device=None,
        **config_overrides,
    ):
        if config is None:
            config = SkyrmionEnvConfig(**config_overrides)
        self.config = config
        self.batch_size = batch_size
        self.device = resolve_device(device, None)
        dtype = config.torch_dtype
        n = config.n_skyrmions
        # Raised by every setter of what a captured step bakes in.
        self._graph_version = 0

        if target_positions is None:
            targets = np.linspace(config.track_length * 0.2, config.track_length * 0.8, n)
        else:
            if len(target_positions) != n:
                raise ValueError("Number of target positions must match number of skyrmions")
            targets = np.asarray(target_positions, float)
        self.set_targets(targets)

        # Pinning sites: random along the track, ~1 per 20 radii, shared by
        # the batch; the JAX package's numpy draws, in its order.
        rng = np.random.default_rng(seed)
        n_sites = int(config.track_length / (20 * config.skyrmion_radius))
        n_sites = max(n_sites, 1) if config.include_pinning else 0
        self.pin_x = torch.as_tensor(rng.uniform(0, config.track_length, n_sites), dtype=dtype,
                                     device=self.device)
        self.pin_strength = torch.as_tensor(
            rng.uniform(0.5, 2.0, n_sites) * config.pinning_strength, dtype=dtype,
            device=self.device,
        )
        self.action_tables = (
            torch.as_tensor(_DIRECTIONS, dtype=dtype, device=self.device),
            torch.as_tensor([0.0, config.max_gradient * 0.5, config.max_gradient], dtype=dtype,
                            device=self.device),
            torch.as_tensor(_DURATION_LEVELS, dtype=dtype, device=self.device),
        )

        if reward_components is None:
            reward_components = _default_reward_config(config)
        self.reward = CompositeReward(reward_components)
        self._graphs = StepGraphs(self) if self.device.type == "cuda" else None

    @property
    def pin_x(self) -> Tensor:
        """The pinning sites' x-positions (S,), shared by the batch."""
        return self._pin_x

    @pin_x.setter
    def pin_x(self, pin_x: Tensor) -> None:
        self._pin_x = pin_x
        self._graph_version += 1

    @property
    def pin_strength(self) -> Tensor:
        """The pinning sites' strengths (S,)."""
        return self._pin_strength

    @pin_strength.setter
    def pin_strength(self, pin_strength: Tensor) -> None:
        self._pin_strength = pin_strength
        self._graph_version += 1

    @property
    def action_tables(self) -> Tuple[Tensor, Tensor, Tensor]:
        """The Discrete(45) decode's tables: the 5 current directions, the 3
        gradients and the 3 durations."""
        return self._directions, self._gradients, self._durations

    @action_tables.setter
    def action_tables(self, tables) -> None:
        self._directions, self._gradients, self._durations = tables
        self._graph_version += 1

    def graph_version(self):
        """The version of what a captured step bakes in as a tensor address
        or a Python number: raised by the ``pin_x``, ``pin_strength`` and
        ``action_tables`` setters and by ``set_targets``, and the reward's
        (``CompositeReward``, its ``version``); part of the captured steps'
        key."""
        return (self._graph_version, self.reward, self.reward.version)

    def _graph_hook(self) -> GraphHook:
        """What the captured step of ``envs.step_graph`` needs of this env:
        its device and batch, the span ``racetrack.replay``, the
        ``racetrack.graph_*`` and ``racetrack.eager_steps`` counters, and its
        keys (the kick and auto-reset generators)."""
        cfg = self.config
        return GraphHook(
            static_key=(str(self.device), self.batch_size), span="racetrack.replay",
            captures=GRAPH_CAPTURES, replays=GRAPH_REPLAYS, eager_steps=EAGER_STEPS,
            keys=functools.partial(_graph_keys, cfg.include_thermal, cfg.autoreset))

    # ------------------------------------------------------------------ API

    def reset(self, seed: int) -> Tuple[SkyrmionEnvState, Any]:
        """A fresh batch; ``seed`` seeds the generator of the reset draws
        and, with the step counter, keys every later step's draws."""
        cfg = self.config
        dtype = cfg.torch_dtype
        B, n = self.batch_size, cfg.n_skyrmions
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        stats = (
            self.reward.init_stats(B, dtype, device=self.device) if self.reward.needs_stats else {}
        )
        zeros = torch.zeros((B,), dtype=dtype, device=self.device)
        state = SkyrmionEnvState(
            positions=self._sample_positions(generator),
            velocities=torch.zeros((B, n, 2), dtype=dtype, device=self.device),
            step=torch.zeros((B,), dtype=torch.int32, device=self.device),
            total_energy=zeros,
            episode_return=zeros,
            seed=seed,
            counter=0,
            reward_stats=stats,
        )
        return state, self.observe(state)

    def step(self, state: SkyrmionEnvState, action, mesh=None):
        """One step of every track: (next state, SkyrmionTimeStep). On CUDA a
        replay of the captured step (``envs.step_graph``); eager on the CPU,
        inside another capture, and for an action that requires grad.
        ``mesh`` is accepted for a step API uniform with SpinTorqueEnv and
        ignored: the tracks are independent."""
        del mesh
        RACETRACK_STEPS.add()
        with span("racetrack.step"):
            if (self._graphs is None or torch.cuda.is_current_stream_capturing()
                    or getattr(action, "requires_grad", False)):
                EAGER_STEPS.add()
                return self._step(state, action)
            return self._graphs.step(self, state, action)

    def set_targets(self, target_x) -> None:
        """Replace the per-skyrmion target x-positions."""
        cfg = self.config
        self.target_x = torch.as_tensor(np.asarray(target_x, float), dtype=cfg.torch_dtype,
                                        device=self.device)  # (n,)
        self._targets = torch.stack(
            [self.target_x, torch.full_like(self.target_x, cfg.track_width / 2.0)], -1
        )  # (n, 2)
        self._graph_version += 1

    @property
    def num_actions(self) -> int:
        return len(_DIRECTIONS) * _N_GRADIENTS * _N_DURATIONS  # 45

    def observe(self, state: SkyrmionEnvState):
        cfg = self.config
        dtype = cfg.torch_dtype
        B, n = state.positions.shape[0], cfg.n_skyrmions
        errors = self._position_errors(state.positions)
        if cfg.observation_mode == "vector":
            vel_mag = _norm(state.velocities)
            # In float32 and then cast, as the JAX package computes it
            # (int32 / int).
            steps_left = ((cfg.max_steps - state.step).float() / cfg.max_steps).to(dtype)
            return torch.cat(
                [
                    state.positions.reshape(B, -1) / cfg.track_length,
                    state.velocities.reshape(B, -1) / 100.0,
                    self._targets.reshape(-1).expand(B, 2 * n) / cfg.track_length,
                    steps_left[:, None],
                    (state.total_energy / 1e-15)[:, None],
                    (errors.mean(-1) / (cfg.track_length * 0.1))[:, None],
                    (vel_mag.mean(-1) / 100.0)[:, None],
                ],
                dim=-1,
            )
        return {
            "positions": state.positions,
            "velocities": state.velocities,
            "target_positions": self.target_x.expand(B, n),
            "position_errors": errors,
            "steps_remaining": (cfg.max_steps - state.step)[:, None],
            "total_energy": state.total_energy[:, None],
        }

    # ------------------------------------------------------------- internals

    def _sample_positions(self, generator) -> Tensor:
        cfg = self.config
        dtype = cfg.torch_dtype
        B, n = self.batch_size, cfg.n_skyrmions
        lo, hi = cfg.skyrmion_radius, cfg.track_length - cfg.skyrmion_radius
        u = torch.rand((B, n), generator=generator, dtype=dtype, device=self.device)
        x = lo + (hi - lo) * u
        y = torch.full((B, n), cfg.track_width / 2.0, dtype=dtype, device=self.device)
        return torch.stack([x, y], dim=-1)

    def _action_tensor(self, action) -> Tensor:
        """The action as a tensor on the env's device (a copy from the host
        for a numpy array): discrete indices in their own dtype, a continuous
        action in the configuration's dtype with a single track's 1-D action
        as one row."""
        if self.config.action_mode != "continuous":
            return torch.as_tensor(action, device=self.device)
        a = torch.as_tensor(action, dtype=self.config.torch_dtype, device=self.device)
        return a[None, :] if a.ndim == 1 else a

    def _decode_action(self, action):
        """(jx, jy, gx, gy, duration), each (B,)."""
        cfg = self.config
        a = self._action_tensor(action)
        if cfg.action_mode == "continuous":
            jx, jy = a[:, 0], a[:, 1]
            gx = a[:, 2] if a.shape[1] > 2 else torch.zeros_like(jx)
            gy = a[:, 3] if a.shape[1] > 3 else torch.zeros_like(jx)
            dur = a[:, 4] if a.shape[1] > 4 else torch.full_like(jx, 1e-9)
        else:
            idx = a.to(torch.int32).reshape(-1)
            dir_idx = torch.clamp(idx // (_N_GRADIENTS * _N_DURATIONS), 0, len(_DIRECTIONS) - 1)
            grad_idx = torch.clamp((idx // _N_DURATIONS) % _N_GRADIENTS, 0, _N_GRADIENTS - 1)
            dur_idx = torch.clamp(idx % _N_DURATIONS, 0, _N_DURATIONS - 1)
            d = self._directions[dir_idx.long()]
            jx = d[:, 0] * cfg.max_current * 0.5
            jy = d[:, 1] * cfg.max_current * 0.5
            gx = self._gradients[grad_idx.long()]
            gy = torch.zeros_like(gx)
            dur = self._durations[dur_idx.long()]
        jx = torch.clamp(jx, -cfg.max_current, cfg.max_current)
        jy = torch.clamp(jy, -cfg.max_current, cfg.max_current)
        gx = torch.clamp(gx, -cfg.max_gradient, cfg.max_gradient)
        gy = torch.clamp(gy, -cfg.max_gradient, cfg.max_gradient)
        dur = torch.clamp(dur, 1e-12, 2e-9)
        return jx, jy, gx, gy, dur

    def _pinning_force(self, positions: Tensor) -> Tensor:
        """Exponential wells along the centerline: (B, n, 2) -> (B, n, 2)."""
        cfg = self.config
        if self.pin_x.shape[0] == 0 or not cfg.include_pinning:
            return torch.zeros_like(positions)
        site = torch.stack([self.pin_x, torch.full_like(self.pin_x, cfg.track_width / 2.0)], -1)
        dvec = positions[:, :, None, :] - site[None, None, :, :]  # (B, n, S, 2)
        dist = _norm(dvec)  # (B, n, S)
        in_range = dist < 3.0 * cfg.skyrmion_radius
        mag = self.pin_strength * torch.exp(-dist / cfg.skyrmion_radius)
        safe = torch.clamp_min(dist, 1e-30)
        force = -(mag * in_range / safe)[..., None] * dvec
        return force.sum(dim=2)

    def _position_errors(self, positions: Tensor) -> Tensor:
        return _norm(positions - self._targets[None, :, :])  # (B, n)

    def _substeps(self, pos: Tensor, vel: Tensor, force: Tensor, dur: Tensor):
        """Ten damped-inertia Euler substeps of ``dur / 10`` under ``force``,
        each clipping the positions to the track and reflecting the velocity
        of a wall hit at -0.5x: (positions, velocities), each (B, n, 2)."""
        cfg = self.config
        magnus_coeff = 4.0 * math.pi * cfg.saturation_magnetization
        mass_eff = magnus_coeff * cfg.skyrmion_radius**2
        dt = (dur / 10.0)[:, None, None]
        lo_x, hi_x = cfg.skyrmion_radius, cfg.track_length - cfg.skyrmion_radius
        lo_y, hi_y = cfg.skyrmion_radius, cfg.track_width - cfg.skyrmion_radius
        for _ in range(10):
            accel = force / mass_eff - cfg.damping * vel
            vel = vel + accel * dt
            pos = pos + vel * dt
            px = torch.clamp(pos[..., 0], lo_x, hi_x)
            py = torch.clamp(pos[..., 1], lo_y, hi_y)
            hit_x = (px <= lo_x) | (px >= hi_x)
            hit_y = (py <= lo_y) | (py >= hi_y)
            vx = torch.where(hit_x, vel[..., 0] * -0.5, vel[..., 0])
            vy = torch.where(hit_y, vel[..., 1] * -0.5, vel[..., 1])
            pos = torch.stack([px, py], -1)
            vel = torch.stack([vx, vy], -1)
        return pos, vel

    def _step(self, state: SkyrmionEnvState, action, kick_generator=None,
              reset_generator=None):
        """The eager step body: (next state, SkyrmionTimeStep). Its thermal
        kicks and auto-reset draw from generators keyed by the state's
        (seed, counter) (``_graph_keys``), unless a captured step passes its
        own, which it seeds to the same values before each replay."""
        cfg = self.config
        dtype = cfg.torch_dtype
        B, n = self.batch_size, cfg.n_skyrmions
        if kick_generator is None or reset_generator is None:
            (kick_generator, reset_generator), set_keys = _graph_keys(
                cfg.include_thermal, cfg.autoreset, self.device)
            set_keys(state)
        with span("racetrack.decode"):
            jx, jy, gx, gy, dur = self._decode_action(action)

        prev_pos = state.positions
        with span("racetrack.forces"):
            # (B, n, 2): drive and Magnus, gradient, pinning, thermal kick.
            j_mag = torch.sqrt(jx * jx + jy * jy)  # (B,)
            safe_j = torch.clamp_min(j_mag, 1e-300 if dtype == torch.float64 else 1e-30)
            dir_x, dir_y = jx / safe_j, jy / safe_j
            f_drive = cfg.spin_hall_angle * j_mag
            f_magnus = f_drive * math.tan(_HALL_ANGLE)
            fx = f_drive * dir_x + f_magnus * (-dir_y)
            fy = f_drive * dir_y + f_magnus * dir_x
            has_j = j_mag > 0
            fx = torch.where(has_j, fx, 0.0)
            fy = torch.where(has_j, fy, 0.0)
            force = torch.stack([fx, fy], -1)[:, None, :]  # (B, 1, 2), broadcast over n
            force = force + torch.stack([gx, gy], -1)[:, None, :] * 1e-24
            force = force.expand(B, n, 2)
            force = force + self._pinning_force(prev_pos)
            if cfg.include_thermal:
                # A random unit direction times the thermal magnitude, per
                # skyrmion per step.
                mag = math.sqrt(2.0 * KB_SOLVER * cfg.temperature / (cfg.skyrmion_radius * 1e-9))
                d = torch.randn((B, n, 2), dtype=dtype, device=self.device,
                                generator=kick_generator)
                d = d / torch.clamp_min(_norm(d, keepdim=True), 1e-30)
                force = force + mag * d

        with span("racetrack.substeps"):
            pos, vel = self._substeps(prev_pos, state.velocities, force, dur)

        with span("racetrack.reward"):
            vel_mag = _norm(vel)  # (B, n)
            stability = torch.exp(-vel_mag / 50.0)

            # The pulse energy.
            area = cfg.track_width * cfg.track_thickness
            voltage = j_mag * cfg.resistivity * cfg.track_length / area
            e_per = voltage**2 / cfg.resistivity * dur * area / cfg.track_length
            step_energy = torch.where(j_mag > 0, e_per, 0.0) * n  # summed over skyrmions

            displacement = _norm(pos - prev_pos).sum(-1)  # (B,)
            total_energy = state.total_energy + step_energy
            step = state.step + 1

            prev_errors = self._position_errors(prev_pos)
            errors = self._position_errors(pos)
            is_success = (errors < cfg.success_threshold).all(-1)
            ctx = RewardContext(
                is_success=is_success,
                step_energy=step_energy,
                alignment=-errors.mean(-1),
                alignment_improvement=(prev_errors - errors).mean(-1),
                magnetization_norm=torch.ones((B,), dtype=dtype, device=self.device),
                step_count=step,
                total_energy=total_energy,
                action_current=j_mag,
                action_duration=dur,
                extras={
                    "position_errors": errors,
                    "velocity_magnitudes": vel_mag,
                    "stability_factors": stability,
                    "total_displacement": displacement,
                },
            )
            reward, breakdown, new_stats = self.reward.compute(ctx, state.reward_stats)
            episode_return = state.episode_return + reward
        terminated = is_success
        truncated = step >= cfg.max_steps
        done = terminated | truncated

        mid_state = dataclasses.replace(state, positions=pos, velocities=vel, step=step,
                                        total_energy=total_energy, counter=state.counter + 1)
        with span("racetrack.observe"):
            obs_step = self.observe(mid_state)

        info = {
            "step_count": step,
            "total_energy": total_energy,
            "position_errors": errors,
            "average_error": errors.mean(-1),
            "is_success": is_success,
            "step_energy": step_energy,
            "stability_factors": stability,
            "total_displacement": displacement,
            "episode_return": episode_return,
            "reward_components": breakdown,
        }

        if cfg.autoreset:
            with span("racetrack.reset"):
                pos_reset = self._sample_positions(reset_generator)
                d2 = done[:, None, None]
                next_state = dataclasses.replace(
                    mid_state,
                    positions=torch.where(d2, pos_reset, pos),
                    velocities=torch.where(d2, 0.0, vel),
                    step=torch.where(done, 0, step),
                    total_energy=torch.where(done, 0.0, total_energy),
                    episode_return=torch.where(done, 0.0, episode_return),
                    reward_stats=new_stats,
                )
                with span("racetrack.observe"):
                    obs_reset = self.observe(next_state)

                def pick(reset, stepped):
                    return torch.where(done.reshape((B,) + (1,) * (stepped.ndim - 1)), reset,
                                       stepped)

                if isinstance(obs_step, dict):
                    obs = {k: pick(obs_reset[k], v) for k, v in obs_step.items()}
                else:
                    obs = pick(obs_reset, obs_step)
            info["final_observation"] = obs_step
        else:
            next_state = dataclasses.replace(
                mid_state, episode_return=episode_return, reward_stats=new_stats
            )
            obs = obs_step

        return next_state, SkyrmionTimeStep(
            obs=obs, reward=reward, terminated=terminated, truncated=truncated, info=info,
        )
