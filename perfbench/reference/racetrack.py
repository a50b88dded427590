"""Plain reference of one SkyrmionRacetrack-v0 step, in PyTorch.

A frozen, self-contained copy of the arithmetic that the racetrack env step
under test is specified to perform, following upstream's
``spin_torque_gym/envs/skyrmion_env.py`` (``SkyrmionRacetrackEnv``, the id
``SkyrmionRacetrack-v0`` of ``envs/__init__.py:14-33``):

- the track and its material (``:31-52``, ``:157-171``); the pinning sites
  (``:173-183``): int(L / (20 r)) of them (at least one), x uniform over
  [0, L), strengths uniform over [0.5, 2) x the pinning strength, on the
  centerline;
- the action (``:412-473``): Discrete(45) (``:265-276``), index i giving
  the direction i // 9 of (+x, -x, +y, -y, none) at 0.5 x max_current, the
  gradient (i // 3) % 3 of (0, 0.5, 1) x max_gradient along x and the
  duration i % 3 of (0.1, 0.5, 1) ns, each part clamped to its table; or
  the continuous Box [Jx, Jy, gx, gy, dt] (``:254-264``); currents clamped
  to +-max_current, gradients to +-max_gradient, dt to [1 ps, 2 ns];
- the force on a skyrmion (``:475-566``): the drive SHA |J| along J and
  the Magnus force tan(20 deg) times it across, none without current; the
  gradient times 1e-24; the pinning wells -s exp(-d / r) (p - site) / d of
  the sites within 3 r; the thermal kick sqrt(2 k_B T / (r 1e-9)) along a
  random unit direction (``:589-600``), k_B 1.38e-23;
- ten Euler substeps of dt / 10 (``:475-566``): a = F / (4 pi Ms r^2) -
  alpha v, v += a dt, p += v dt, p clipped to [r, L - r] x [r, W - r], the
  velocity of a clipped component reflected at -0.5x;
- the pulse energy V^2 / rho dt A / L with V = |J| rho L / A and A = W t,
  in that order (its intermediates reach ~1e36 at |J| = 1e12, inside
  float32), times the skyrmions, none without current;
- the five reward terms with their weights (``:185-252``), summed in this
  order: positioning 10 x the mean over skyrmions of (10 within the
  success threshold, else max(5 (1 - e / (0.1 L)), 0)); energy -w x
  (-E / 1 fJ); velocity -1 x the sum of (|v| - 100) / 100 over |v| > 100;
  stability 5 x the mean of exp(-|v| / 50); efficiency 2 x
  min(displacement / (E / 1 fJ), 10) where E > 0, else 0;
- success when every skyrmion lies within the threshold of its target
  (``:48``, ``:376``), truncation at max_steps; the vector observation
  (``:278-306``, ``:612-645``): positions / L, velocities / 100, targets /
  L, steps left / max_steps, E / 1 fJ, the mean error / (0.1 L) and the
  mean |v| / 100.

Departures, each the port's and the benchmark's deployment (the
configuration's ``assumed``), not upstream's:

- the pinning sites are drawn once, with numpy's ``default_rng(seed)``
  (x first, then the strengths), and shared by the batch; upstream draws
  them for each env instance;
- the auto-reset happens inside the step: a finished track gets fresh
  skyrmions at x uniform over [r, L - r] on the centerline at rest, its
  step, energy and return zeroed, its observation the fresh one;
- the draws come from torch generators: the reset at an episode's start
  from one seeded with the seed, step k's kicks (normals over their norm)
  from one seeded with derive_seed(derive_seed(seed, k), KICK_STREAM), its
  auto-reset from one with RESET_STREAM;
- the op order of the port where it sets the bits: norms as the square
  root of summed squares, each Python number applied to a tensor as it
  stands in the expressions below (one rounding each), the reward's terms
  computed one by one and summed in order. On one device the result is
  then the same bits as any implementation that keeps that order.

It imports nothing but torch, numpy and the SpinTorque reference (for its
seed derivation). It receives only what the benchmark hands to both sides
(the configuration's numbers, the seeds, the actions) and, where it
follows the program step by step, the state a step started from.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from perfbench.reference import spintorque as st

Tensor = torch.Tensor

KB = 1.38e-23  # upstream's k_B of the thermal kick
HALL_ANGLE = math.radians(20.0)
RESET_STREAM = 1
KICK_STREAM = 2
DIRECTIONS = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0), (0.0, 0.0))
DURATIONS = (0.1e-9, 0.5e-9, 1.0e-9)


class Env(NamedTuple):
    """The configuration of the env, from the configuration file."""

    length: float
    width: float
    thickness: float
    n: int  # skyrmions a track
    radius: float
    max_steps: int
    max_current: float
    max_gradient: float
    temperature: float
    thermal: bool
    discrete: bool
    success_threshold: float
    energy_weight: float
    autoreset: bool
    ms: float
    damping: float
    spin_hall_angle: float
    resistivity: float
    pin_x: Tensor  # (S,)
    pin_strength: Tensor  # (S,)
    targets: Tensor  # (n, 2)
    directions: Tensor  # (5, 2)
    gradients: Tensor  # (3,)
    durations: Tensor  # (3,)


def _norm(v: Tensor, keepdim: bool = False) -> Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def make_env(config: Dict, pin_seed: int, device) -> Env:
    """The reference's view of a configuration file, with the pinning sites
    drawn from ``pin_seed``."""
    e = config["env"]
    if (e["observation_mode"], e["dtype"], e["action_mode"] in ("discrete", "continuous")) != (
            "vector", "float32", True):
        raise ValueError("the reference covers vector observations in float32")
    f32 = dict(dtype=torch.float32, device=device)
    length, radius = float(e["track_length"]), float(e["skyrmion_radius"])
    n = int(e["n_skyrmions"])
    rng = np.random.default_rng(pin_seed)
    sites = max(int(length / (20 * radius)), 1) if e["include_pinning"] else 0
    pin_x = torch.as_tensor(rng.uniform(0, length, sites), **f32)
    pin_strength = torch.as_tensor(rng.uniform(0.5, 2.0, sites) * float(e["pinning_strength"]),
                                   **f32)
    target_x = torch.as_tensor(np.asarray(config["target_positions"], float), **f32)
    if target_x.shape != (n,):
        raise ValueError("one target position a skyrmion")
    width = float(e["track_width"])
    max_gradient = float(e["max_gradient"])
    return Env(
        length=length, width=width, thickness=float(e["track_thickness"]), n=n, radius=radius,
        max_steps=int(e["max_steps"]), max_current=float(e["max_current"]),
        max_gradient=max_gradient, temperature=float(e["temperature"]),
        thermal=bool(e["include_thermal"]), discrete=e["action_mode"] == "discrete",
        success_threshold=float(e["success_threshold"]),
        energy_weight=float(e["energy_penalty_weight"]), autoreset=bool(e["autoreset"]),
        ms=float(e["saturation_magnetization"]), damping=float(e["damping"]),
        spin_hall_angle=float(e["spin_hall_angle"]), resistivity=float(e["resistivity"]),
        pin_x=pin_x, pin_strength=pin_strength,
        targets=torch.stack([target_x, torch.full_like(target_x, width / 2.0)], -1),
        directions=torch.as_tensor(DIRECTIONS, **f32),
        gradients=torch.as_tensor([0.0, max_gradient * 0.5, max_gradient], **f32),
        durations=torch.as_tensor(DURATIONS, **f32),
    )


class State(NamedTuple):
    positions: Tensor  # (B, n, 2)
    velocities: Tensor  # (B, n, 2)
    step: Tensor  # (B,) int32
    total_energy: Tensor
    episode_return: Tensor


def generator(seed: int, counter: int, stream: int, device) -> torch.Generator:
    """The generator of stream ``stream`` of step ``counter``."""
    g = torch.Generator(device=device)
    g.manual_seed(st.derive_seed(st.derive_seed(seed, counter), stream))
    return g


def sample_positions(env: Env, g: torch.Generator, batch: int, device) -> Tensor:
    """x uniform over [r, L - r], y on the centerline."""
    lo, hi = env.radius, env.length - env.radius
    u = torch.rand((batch, env.n), generator=g, dtype=torch.float32, device=device)
    x = lo + (hi - lo) * u
    y = torch.full((batch, env.n), env.width / 2.0, dtype=torch.float32, device=device)
    return torch.stack([x, y], dim=-1)


def reset(env: Env, seed: int, batch: int, device) -> State:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    zeros = torch.zeros((batch,), dtype=torch.float32, device=device)
    return State(sample_positions(env, g, batch, device),
                 torch.zeros((batch, env.n, 2), dtype=torch.float32, device=device),
                 torch.zeros((batch,), dtype=torch.int32, device=device), zeros, zeros)


def decode(env: Env, action: Tensor):
    """(jx, jy, gx, gy, duration), each (B,)."""
    if env.discrete:
        idx = action.to(torch.int32).reshape(-1)
        d = env.directions[torch.clamp(idx // 9, 0, 4).long()]
        jx = d[:, 0] * env.max_current * 0.5
        jy = d[:, 1] * env.max_current * 0.5
        gx = env.gradients[torch.clamp((idx // 3) % 3, 0, 2).long()]
        gy = torch.zeros_like(gx)
        dur = env.durations[torch.clamp(idx % 3, 0, 2).long()]
    else:
        a = action.float()
        a = a[None, :] if a.ndim == 1 else a
        jx, jy = a[:, 0], a[:, 1]
        gx = a[:, 2] if a.shape[1] > 2 else torch.zeros_like(jx)
        gy = a[:, 3] if a.shape[1] > 3 else torch.zeros_like(jx)
        dur = a[:, 4] if a.shape[1] > 4 else torch.full_like(jx, 1e-9)
    jx = torch.clamp(jx, -env.max_current, env.max_current)
    jy = torch.clamp(jy, -env.max_current, env.max_current)
    gx = torch.clamp(gx, -env.max_gradient, env.max_gradient)
    gy = torch.clamp(gy, -env.max_gradient, env.max_gradient)
    return jx, jy, gx, gy, torch.clamp(dur, 1e-12, 2e-9)


def position_errors(env: Env, positions: Tensor) -> Tensor:
    return _norm(positions - env.targets[None, :, :])  # (B, n)


def pinning(env: Env, positions: Tensor) -> Tensor:
    """The wells' force on each skyrmion: (B, n, 2)."""
    if env.pin_x.shape[0] == 0:
        return torch.zeros_like(positions)
    site = torch.stack([env.pin_x, torch.full_like(env.pin_x, env.width / 2.0)], -1)
    dvec = positions[:, :, None, :] - site[None, None, :, :]  # (B, n, S, 2)
    dist = _norm(dvec)
    in_range = dist < 3.0 * env.radius
    mag = env.pin_strength * torch.exp(-dist / env.radius)
    safe = torch.clamp_min(dist, 1e-30)
    return (-(mag * in_range / safe)[..., None] * dvec).sum(dim=2)


def forces(env: Env, positions: Tensor, jx, jy, gx, gy, kick: torch.Generator):
    """(|J| (B,), the force on each skyrmion (B, n, 2))."""
    b = positions.shape[0]
    j_mag = torch.sqrt(jx * jx + jy * jy)
    safe_j = torch.clamp_min(j_mag, 1e-30)
    dir_x, dir_y = jx / safe_j, jy / safe_j
    f_drive = env.spin_hall_angle * j_mag
    f_magnus = f_drive * math.tan(HALL_ANGLE)
    has_j = j_mag > 0
    fx = torch.where(has_j, f_drive * dir_x + f_magnus * (-dir_y), 0.0)
    fy = torch.where(has_j, f_drive * dir_y + f_magnus * dir_x, 0.0)
    force = torch.stack([fx, fy], -1)[:, None, :]
    force = force + torch.stack([gx, gy], -1)[:, None, :] * 1e-24
    force = force.expand(b, env.n, 2) + pinning(env, positions)
    if env.thermal:
        mag = math.sqrt(2.0 * KB * env.temperature / (env.radius * 1e-9))
        d = torch.randn((b, env.n, 2), dtype=torch.float32, device=positions.device,
                        generator=kick)
        d = d / torch.clamp_min(_norm(d, keepdim=True), 1e-30)
        force = force + mag * d
    return j_mag, force


def substeps(env: Env, pos: Tensor, vel: Tensor, force: Tensor, dur: Tensor):
    """Ten Euler substeps with damped inertia and reflecting walls."""
    mass = 4.0 * math.pi * env.ms * env.radius**2
    dt = (dur / 10.0)[:, None, None]
    lo_x, hi_x = env.radius, env.length - env.radius
    lo_y, hi_y = env.radius, env.width - env.radius
    for _ in range(10):
        vel = vel + (force / mass - env.damping * vel) * dt
        pos = pos + vel * dt
        px = torch.clamp(pos[..., 0], lo_x, hi_x)
        py = torch.clamp(pos[..., 1], lo_y, hi_y)
        vx = torch.where((px <= lo_x) | (px >= hi_x), vel[..., 0] * -0.5, vel[..., 0])
        vy = torch.where((py <= lo_y) | (py >= hi_y), vel[..., 1] * -0.5, vel[..., 1])
        pos = torch.stack([px, py], -1)
        vel = torch.stack([vx, vy], -1)
    return pos, vel


def pulse_energy(env: Env, j_mag: Tensor, dur: Tensor) -> Tensor:
    area = env.width * env.thickness
    voltage = j_mag * env.resistivity * env.length / area
    e = voltage**2 / env.resistivity * dur * area / env.length
    return torch.where(j_mag > 0, e, 0.0) * env.n


def reward(env: Env, errors, step_energy, vel_mag, stability, displacement) -> Tensor:
    positioning = torch.where(errors < env.success_threshold, 10.0,
                              torch.clamp_min(5.0 * (1.0 - errors / (env.length * 0.1)), 0.0))
    efficiency = torch.clamp_max(displacement / (step_energy / 1e-15), 10.0)
    total = 10.0 * positioning.mean(-1)
    total = total + -env.energy_weight * (-step_energy / 1e-15)
    total = total + -1.0 * torch.where(vel_mag > 100.0, (vel_mag - 100.0) / 100.0, 0.0).sum(-1)
    total = total + 5.0 * stability.mean(-1)
    return total + 2.0 * torch.where(step_energy > 0, efficiency, 0.0)


def observe(env: Env, s: State) -> Tensor:
    b = s.positions.shape[0]
    left = ((env.max_steps - s.step).float() / env.max_steps)[:, None]
    errors = position_errors(env, s.positions)
    return torch.cat([s.positions.reshape(b, -1) / env.length,
                      s.velocities.reshape(b, -1) / 100.0,
                      env.targets.reshape(-1).expand(b, 2 * env.n) / env.length, left,
                      (s.total_energy / 1e-15)[:, None],
                      (errors.mean(-1) / (env.length * 0.1))[:, None],
                      (_norm(s.velocities).mean(-1) / 100.0)[:, None]], dim=-1)


class StepOut(NamedTuple):
    final_obs: Tensor  # the observation after the substeps, before the auto-reset
    obs: Tensor
    reward: Tensor
    terminated: Tensor
    truncated: Tensor
    next_state: State


def step(env: Env, s: State, action: Tensor, seed: int, counter: int) -> StepOut:
    """One step of the whole batch from state ``s``; ``seed`` and
    ``counter`` key the kicks and the auto-reset."""
    device = s.positions.device
    jx, jy, gx, gy, dur = decode(env, action)
    j_mag, force = forces(env, s.positions, jx, jy, gx, gy,
                          generator(seed, counter, KICK_STREAM, device))
    pos, vel = substeps(env, s.positions, s.velocities, force, dur)
    vel_mag = _norm(vel)
    step_energy = pulse_energy(env, j_mag, dur)
    displacement = _norm(pos - s.positions).sum(-1)
    errors = position_errors(env, pos)
    rew = reward(env, errors, step_energy, vel_mag, torch.exp(-vel_mag / 50.0), displacement)
    n_step = s.step + 1
    terminated = (errors < env.success_threshold).all(-1)
    truncated = n_step >= env.max_steps
    done = terminated | truncated
    nxt = State(pos, vel, n_step, s.total_energy + step_energy, s.episode_return + rew)
    final_obs = obs = observe(env, nxt)
    if env.autoreset:
        fresh = sample_positions(env, generator(seed, counter, RESET_STREAM, device),
                                 pos.shape[0], device)
        d2 = done[:, None, None]
        nxt = State(torch.where(d2, fresh, pos), torch.where(d2, 0.0, vel),
                    torch.where(done, 0, n_step), torch.where(done, 0.0, nxt.total_energy),
                    torch.where(done, 0.0, nxt.episode_return))
        obs = torch.where(done[:, None], observe(env, nxt), final_obs)
    return StepOut(final_obs, obs, rew, terminated, truncated, nxt)
