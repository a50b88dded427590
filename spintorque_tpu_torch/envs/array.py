"""Vectorized crossbar array environment (SpinTorqueArray-v0) in PyTorch.

Counterpart of ``spintorque_tpu/envs/array.py``. A batch of B independent
N = rows x cols crossbar arrays steps together. Both coupling updates of
the JAX package are kept:

  * ``sequential`` (the default, the reference's semantics): the affected
    devices of an array are updated one after another, each seeing the
    devices before it already updated through the coupling field. The JAX
    package scans over the N devices; here it is a Python loop over them,
    writing each device's result into one clone of the pattern per step.
  * ``simultaneous``: every substep assembles all devices' coupling fields
    from the same pattern in one (N, N) x (B, N, 3) product and advances
    every affected device together (permutation-equivariant).

The per-device law is the reference's inline 10-substep Euler with a
hardcoded alpha = 0.01 and gamma, and tau = 0.1 J m x (m x z); devices
driven by |J| <= 1e-12 stay exactly put; the energy is J^2 A^2 R dt at the
pre-update resistance of each affected device. Each sweep computes from
the pattern flushed of float subnormals (to a zero of their sign,
``physics.integrator.flush_subnormal``) as XLA's arithmetic reads it, so a
device at a pole with subnormal transverse parts stays there, as in the
JAX package; a device the sweep does not move keeps its input unflushed,
as XLA's select passes it through. The 'global' action mode reads the current
from action[1] and always pulses 1 ns, and thermal fluctuations are
accepted but never applied, as in the reference.

The reset draws come from a torch.Generator seeded with the reset seed;
step k's auto-reset draws from one seeded from the state's (seed, k) under
a stream tag of its own (``ops.philox.step_generator``). The state holds
no generator, and ``step`` writes into no tensor of the state it is given,
so a step is a function of its state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import GAMMA, MU0
from ..devices import make_device_params
from ..devices.resistance import pulse_energy as _pulse_energy
from ..devices.resistance import resistance as _resistance
from ..ops.philox import RESET_STREAM, step_generator
from ..parallel.mesh import resolve_device
from ..physics.integrator import flush_subnormal
from ..rewards import CompositeReward, RewardContext, RunningStat
from ..utils.profiling import counter, span

Tensor = torch.Tensor

# Host counters, counted whatever the tracing switch: steps, and devices
# swept a step (N in either coupling mode: one after another in the
# sequential sweep, N updates of 10 substeps each; all together in the
# simultaneous one, one set of 10 substeps over the N).
ARRAY_STEPS = counter("array.steps")
DEVICE_UPDATES = counter("array.device_updates")

_HARDCODED_ALPHA = 0.01
_HARDCODED_GAMMA = GAMMA


class ArrayEnvConfig(NamedTuple):
    """Static configuration."""

    rows: int = 4
    cols: int = 4
    device_type: str = "stt_mram"
    max_steps: int = 200
    max_current: float = 2e6
    max_duration: float = 5e-9
    temperature: float = 300.0
    include_coupling: bool = True
    coupling_strength: float = 0.1
    coupling_type: str = "dipolar"  # 'dipolar' | 'exchange' | 'stray_field'
    action_mode: str = "individual"  # 'individual' | 'row' | 'column' | 'global'
    observation_mode: str = "array"  # 'array' | 'vector' | 'dict'
    coupling_update: str = "sequential"  # 'sequential' | 'simultaneous'
    success_threshold: float = 0.9
    energy_penalty_weight: float = 0.1
    autoreset: bool = True
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_devices(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class ArrayEnvState:
    pattern: Tensor  # (B, N, 3) row-major device magnetizations
    target: Tensor  # (B, N, 3)
    step: Tensor  # (B,) int32
    total_energy: Tensor  # (B,)
    episode_return: Tensor  # (B,)
    seed: int  # the reset seed; with counter, the key of a step's draws
    counter: int  # steps taken since reset
    reward_stats: Dict[str, RunningStat] = dataclasses.field(default_factory=dict)


class ArrayTimeStep(NamedTuple):
    obs: Any
    reward: Any
    terminated: Any
    truncated: Any
    info: Dict[str, Any]


def coupling_matrix(cfg: ArrayEnvConfig) -> np.ndarray:
    """(N, N) inter-device coupling."""
    N = cfg.n_devices
    C = np.zeros((N, N))
    if not cfg.include_coupling:
        return C
    for i in range(N):
        for j in range(N):
            if i == j:
                continue
            ir, ic = divmod(i, cfg.cols)
            jr, jc = divmod(j, cfg.cols)
            d = np.sqrt((ir - jr) ** 2 + (ic - jc) ** 2)
            if cfg.coupling_type == "dipolar" and d > 0:
                C[i, j] = cfg.coupling_strength / d**3
            elif cfg.coupling_type == "exchange" and d == 1:
                C[i, j] = cfg.coupling_strength
            elif cfg.coupling_type == "stray_field" and d > 0:
                C[i, j] = cfg.coupling_strength / d**2
    return C


def checkerboard_pattern(rows: int, cols: int) -> np.ndarray:
    """Default +-z checkerboard target."""
    pattern = np.zeros((rows, cols, 3))
    for i in range(rows):
        for j in range(cols):
            pattern[i, j, 2] = 1.0 if (i + j) % 2 == 0 else -1.0
    return pattern


def _default_reward_config(cfg: ArrayEnvConfig) -> Dict[str, Dict]:
    def pattern_match(ctx: RewardContext):
        similarity = ctx.extras["pattern_similarity"]
        return torch.where(ctx.is_success, 10.0, similarity * 5.0)

    def energy(ctx: RewardContext):
        return -ctx.step_energy / 1e-12

    def progress(ctx: RewardContext):
        return ctx.extras["pattern_improvement"]

    def uniformity(ctx: RewardContext):
        return torch.clamp_min(1.0 - ctx.extras["magnitude_std"], 0.0)

    return {
        "pattern_match": {"weight": 10.0, "function": pattern_match},
        "energy": {"weight": -cfg.energy_penalty_weight, "function": energy},
        "progress": {"weight": 1.0, "function": progress},
        "uniformity": {"weight": 2.0, "function": uniformity},
    }


def _norm(v: Tensor) -> Tensor:
    """|v| over the last axis, keeping it."""
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


class SpinTorqueArrayEnv:
    """Vectorized crossbar array environment (functional API).

    Usage:
        env = SpinTorqueArrayEnv(batch_size=4096)
        state, obs = env.reset(seed=0)
        state, ts = env.step(state, actions)  # (B, 3) [index, J, duration]

    ``device`` is "cuda" unless the caller asks for "cpu".
    """

    def __init__(
        self,
        array_size: Tuple[int, int] = (4, 4),
        device_type: str = "stt_mram",
        device_params: Optional[Dict[str, Any]] = None,
        target_pattern: Optional[np.ndarray] = None,
        batch_size: int = 1,
        reward_components: Optional[Dict[str, Dict]] = None,
        config: Optional[ArrayEnvConfig] = None,
        *,
        device=None,
        **config_overrides,
    ):
        if config is None:
            config = ArrayEnvConfig(
                rows=array_size[0], cols=array_size[1], device_type=device_type,
                **config_overrides,
            )
        if config.coupling_update not in ("sequential", "simultaneous"):
            raise ValueError(
                "coupling_update must be 'sequential' or 'simultaneous', got "
                f"{config.coupling_update!r}"
            )
        self.config = config
        self.batch_size = batch_size
        self.device = resolve_device(device, None)
        dtype = config.torch_dtype

        self.device_params = make_device_params(
            config.device_type, device_params, dtype=dtype, device=self.device
        )
        self.coupling = torch.as_tensor(coupling_matrix(config), dtype=dtype, device=self.device)

        if target_pattern is None:
            target = checkerboard_pattern(config.rows, config.cols)
        else:
            target = np.asarray(target_pattern, float)
            if target.shape != (config.rows, config.cols, 3):
                raise ValueError(
                    f"Target pattern shape must be {(config.rows, config.cols, 3)}"
                )
        self.target_pattern = torch.as_tensor(
            target.reshape(config.n_devices, 3), dtype=dtype, device=self.device
        )
        e = self.device_params.easy_axis
        self._easy_axis = e / _norm(e)
        self._p_hat = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=self.device)

        if reward_components is None:
            reward_components = _default_reward_config(config)
        self.reward = CompositeReward(reward_components)

    # ------------------------------------------------------------------ API

    def reset(self, seed: int) -> Tuple[ArrayEnvState, Any]:
        """A fresh batch; ``seed`` seeds the generator of the reset draws
        and, with the step counter, keys every later step's draws."""
        cfg = self.config
        dtype = cfg.torch_dtype
        B, N = self.batch_size, cfg.n_devices
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        stats = (
            self.reward.init_stats(B, dtype, device=self.device) if self.reward.needs_stats else {}
        )
        zeros = torch.zeros((B,), dtype=dtype, device=self.device)
        state = ArrayEnvState(
            pattern=self._sample_pattern(generator),
            target=self.target_pattern.expand(B, N, 3),
            step=torch.zeros((B,), dtype=torch.int32, device=self.device),
            total_energy=zeros,
            episode_return=zeros,
            seed=seed,
            counter=0,
            reward_stats=stats,
        )
        return state, self.observe(state)

    def step(self, state: ArrayEnvState, action, mesh=None) -> Tuple[ArrayEnvState, ArrayTimeStep]:
        """One step. ``mesh`` is accepted for a step API uniform with
        SpinTorqueEnv and ignored: the arrays are independent."""
        del mesh
        ARRAY_STEPS.add()
        with span("array.step"):
            return self._step(state, action)

    def observe(self, state: ArrayEnvState):
        cfg = self.config
        dtype = cfg.torch_dtype
        B = state.pattern.shape[0]
        if cfg.observation_mode == "array":
            cur = state.pattern.reshape(B, cfg.rows, cfg.cols, 3)
            tgt = state.target.reshape(B, cfg.rows, cfg.cols, 3)
            return torch.cat([cur, tgt], dim=-1)
        similarity = self._similarity(state.pattern, state.target)
        if cfg.observation_mode == "vector":
            # In float32 and then cast, as the JAX package computes it
            # (int32 / int).
            steps_left = ((cfg.max_steps - state.step).float() / cfg.max_steps).to(dtype)
            return torch.cat(
                [
                    state.pattern.reshape(B, -1),
                    state.target.reshape(B, -1),
                    similarity[:, None],
                    steps_left[:, None],
                    (state.total_energy / 1e-12)[:, None],
                    torch.full((B, 1), cfg.temperature / 300.0, dtype=dtype, device=self.device),
                ],
                dim=-1,
            )
        return {
            "current_pattern": state.pattern.reshape(B, cfg.rows, cfg.cols, 3),
            "target_pattern": state.target.reshape(B, cfg.rows, cfg.cols, 3),
            "pattern_similarity": similarity[:, None],
            "steps_remaining": (cfg.max_steps - state.step)[:, None],
            "total_energy": state.total_energy[:, None],
        }

    # ------------------------------------------------------------- internals

    def _sample_pattern(self, generator) -> Tensor:
        m = torch.randn((self.batch_size, self.config.n_devices, 3), generator=generator,
                        dtype=self.config.torch_dtype, device=self.device)
        return m / _norm(m)

    def _decode_action(self, action):
        """(affected mask (B, N), current (B,), duration (B,))."""
        cfg = self.config
        dtype = cfg.torch_dtype
        action = torch.as_tensor(action, dtype=dtype, device=self.device)
        if action.ndim == 1:
            action = action[None, :]
        B, N = action.shape[0], cfg.n_devices
        index = torch.arange(N, device=self.device)
        current = action[:, 1]
        if cfg.action_mode == "global":
            # The reference's indexing: the current comes from action[1], and
            # a 2-element global action has no duration, so it is 1 ns.
            duration = torch.full((B,), 1e-9, dtype=dtype, device=self.device)
            mask = torch.ones((B, N), dtype=torch.bool, device=self.device)
        else:
            sel = action[:, 0].to(torch.int32)
            if action.shape[1] > 2:
                duration = action[:, 2]
            else:
                duration = torch.full((B,), 1e-9, dtype=dtype, device=self.device)
            if cfg.action_mode == "individual":
                mask = index[None, :] == torch.clamp(sel, 0, N - 1)[:, None]
            elif cfg.action_mode == "row":
                mask = (index // cfg.cols)[None, :] == torch.clamp(sel, 0, cfg.rows - 1)[:, None]
            elif cfg.action_mode == "column":
                mask = (index % cfg.cols)[None, :] == torch.clamp(sel, 0, cfg.cols - 1)[:, None]
            else:
                raise ValueError(f"Unknown action mode: {cfg.action_mode}")
        current = torch.clamp(current, -cfg.max_current, cfg.max_current)
        duration = torch.clamp(duration, 1e-12, cfg.max_duration)
        return mask, current, duration

    def _anisotropy_field(self) -> Tensor:
        p = self.device_params
        return 2.0 * p.uniaxial_anisotropy / (MU0 * p.saturation_magnetization)

    def _device_field(self, pattern: Tensor, d: int) -> Tensor:
        """Effective field of device d: the intrinsic anisotropy field and
        the coupling sum over the current (partly updated) pattern."""
        e = self._easy_axis
        cos_t = pattern[:, d, :] @ e
        h = self._anisotropy_field() * cos_t[:, None] * e[None, :]
        return h + torch.einsum("n,bnc->bc", self.coupling[d], pattern)

    def _device_update(self, m, h_eff, current, duration):
        """Constant-slope 10-substep Euler."""
        tau = 0.1 * current[:, None] * _cross(m, _cross(m, self._p_hat.expand_as(m)))
        dmdt = -_HARDCODED_GAMMA * _cross(m, h_eff)
        dmdt = dmdt + _HARDCODED_ALPHA * _cross(m, dmdt)
        dmdt = dmdt + tau
        dt = (duration / 10.0)[:, None]
        out = m
        for _ in range(10):
            out = out + dmdt * dt
            out = out / _norm(out)
        # Zero-current devices stay exactly put.
        return torch.where((current.abs() > 1e-12)[:, None], out, m)

    def _sequential_sweep(self, pattern, mask, current, duration):
        """Device d sees devices < d already updated; one copy of the
        pattern per step, flushed of subnormals, takes every device's
        result; the devices it does not move keep their unflushed input."""
        cfg = self.config
        held = pattern
        pattern = flush_subnormal(pattern)
        energy = torch.zeros_like(current)
        for d in range(cfg.n_devices):
            m_d = pattern[:, d, :]
            h = self._device_field(pattern, d)
            m_new = self._device_update(m_d, h, current, duration)
            active = mask[:, d]
            m_out = torch.where(active[:, None], m_new, m_d)
            r = _resistance(cfg.device_type, m_d[:, 0], m_d[:, 1], m_d[:, 2], self.device_params)
            e = _pulse_energy(current, duration, r, self.device_params.area)
            energy = energy + torch.where(active, e, 0.0)
            pattern[:, d, :] = m_out  # last: m_d views this row
        moved = mask & (current.abs() > 1e-12)[:, None]
        return torch.where(moved[..., None], pattern, held), energy

    def _simultaneous_sweep(self, pattern, mask, current, duration):
        """All affected devices advance together: each of the 10 Euler
        substeps assembles every device's field from the same pre-substep
        pattern and refreshes the slope. Same per-device law as the
        sequential mode, so the two differ only in coupling semantics."""
        cfg = self.config
        e = self._easy_axis
        h_k = self._anisotropy_field()
        j = current[:, None, None]
        dt = (duration / 10.0)[:, None, None]
        act = (mask & (current.abs()[:, None] > 1e-12))[:, :, None]
        held = pattern
        pattern = flush_subnormal(pattern)
        m = pattern
        for _ in range(10):
            cos_t = torch.einsum("bnc,c->bn", m, e)
            h = h_k * cos_t[..., None] * e
            h = h + torch.einsum("nm,bmc->bnc", self.coupling, m)
            prec = -_HARDCODED_GAMMA * _cross(m, h)
            dmdt = prec + _HARDCODED_ALPHA * _cross(m, prec)
            dmdt = dmdt + 0.1 * j * _cross(m, _cross(m, self._p_hat.expand_as(m)))
            out = m + dmdt * dt
            out = out / _norm(out)
            m = torch.where(act, out, m)
        # The sequential mode's energy law: each affected device's pre-step
        # resistance.
        r = _resistance(cfg.device_type, pattern[..., 0], pattern[..., 1], pattern[..., 2],
                        self.device_params)
        e_dev = _pulse_energy(current[:, None], duration[:, None], r, self.device_params.area)
        return torch.where(act, m, held), torch.where(mask, e_dev, 0.0).sum(-1)

    def _similarity(self, pattern, target):
        return (pattern * target).sum(-1).mean(-1)

    def _step(self, state: ArrayEnvState, action):
        cfg = self.config
        B = self.batch_size
        with span("array.decode"):
            mask, current, duration = self._decode_action(action)
        prev_similarity = self._similarity(state.pattern, state.target)

        with span("array.sweep"):
            if cfg.coupling_update == "simultaneous":
                pattern, step_energy = self._simultaneous_sweep(state.pattern, mask, current,
                                                                duration)
            else:
                pattern, step_energy = self._sequential_sweep(state.pattern, mask, current,
                                                              duration)
            DEVICE_UPDATES.add(cfg.n_devices)

        total_energy = state.total_energy + step_energy
        step = state.step + 1

        with span("array.reward"):
            similarity = self._similarity(pattern, state.target)
            improvement = similarity - prev_similarity
            is_success = similarity >= cfg.success_threshold
            magnitudes = torch.linalg.vector_norm(pattern, dim=-1)  # (B, N)
            ctx = RewardContext(
                is_success=is_success,
                step_energy=step_energy,
                alignment=similarity,
                alignment_improvement=improvement,
                magnetization_norm=magnitudes.mean(-1),
                step_count=step,
                total_energy=total_energy,
                action_current=current,
                action_duration=duration,
                extras={
                    "pattern_similarity": similarity,
                    "pattern_improvement": improvement,
                    # The population std, as JAX's.
                    "magnitude_std": magnitudes.std(-1, correction=0),
                },
            )
            reward, breakdown, new_stats = self.reward.compute(ctx, state.reward_stats)
            episode_return = state.episode_return + reward
        terminated = is_success
        truncated = step >= cfg.max_steps
        done = terminated | truncated

        mid_state = dataclasses.replace(state, pattern=pattern, step=step,
                                        total_energy=total_energy, counter=state.counter + 1)
        with span("array.observe"):
            obs_step = self.observe(mid_state)

        info = {
            "step_count": step,
            "total_energy": total_energy,
            "pattern_similarity": similarity,
            "pattern_improvement": improvement,
            "is_success": is_success,
            "step_energy": step_energy,
            "episode_return": episode_return,
            "reward_components": breakdown,
        }

        if cfg.autoreset:
            with span("array.reset"):
                m_reset = self._sample_pattern(
                    step_generator(state.seed, state.counter, RESET_STREAM, self.device))
                next_state = dataclasses.replace(
                    mid_state,
                    pattern=torch.where(done[:, None, None], m_reset, pattern),
                    step=torch.where(done, 0, step),
                    total_energy=torch.where(done, 0.0, total_energy),
                    episode_return=torch.where(done, 0.0, episode_return),
                    reward_stats=new_stats,
                )
                with span("array.observe"):
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

        return next_state, ArrayTimeStep(
            obs=obs, reward=reward, terminated=terminated, truncated=truncated, info=info,
        )
