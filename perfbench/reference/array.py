"""Plain reference of one SpinTorqueArray-v0 step, in PyTorch.

A frozen, self-contained copy of the arithmetic that the array env step
under test is specified to perform, following upstream's
``spin_torque_gym/envs/array_env.py`` (``SpinTorqueArrayEnv``):

- the action ``[index, I, dt]`` in the ``individual`` mode (``:223-254``,
  ``:413-443``): the index truncated to an integer and clamped to the
  devices, I clamped to +-max_current, dt to [1 ps, max_duration];
- the sweep: the devices of an array updated one after another in index
  order, each device's effective field its own anisotropy field
  h_k (m . e) e plus sum_j C[d, j] m_j over the partly updated pattern
  (``:478-495``), C the dipolar coupling strength / r^3 (``:289-318``);
  the device law upstream's inline Euler (``:497-531``): one slope
  dm/dt = -gamma m x H + alpha m x (-gamma m x H) + 0.1 I m x (m x z),
  alpha and gamma hard-coded, taken ten times over dt / 10 with a
  renormalization after each, a device driven by |I| <= 1e-12 held;
- the Joule energy (J R A)^2 / R dt of the pulsed device at its
  resistance before its update; the similarity, the mean over the devices
  of m . target (``:533-541``), and its improvement;
- the four reward components with their weights (``:182-221``): pattern
  match 10 x (10 on success, else 5 x similarity), energy
  -w x (-E / 1 pJ), progress 1 x improvement, uniformity
  2 x max(1 - std of |m|, 0), summed in that order;
- success at similarity >= threshold, truncation at max_steps, the array
  observation [pattern, target] of shape (rows, cols, 6).

Departures, each the port's and the benchmark's deployment (the
configuration's ``assumed``), not upstream's:

- the auto-reset inside the step: a finished array gets a fresh random
  pattern (normals over their norm) drawn from a generator seeded with
  ``derive_seed(derive_seed(seed, counter), RESET_STREAM)``, its step,
  energy and return zeroed, its observation the fresh one;
- the sweep computes from the pattern flushed of float subnormals (to a
  zero of their sign) and leaves a device it does not move with its
  unflushed input;
- the op order of the port where it fixes the bits: the field and the
  coupling sum by ``@`` and ``torch.einsum`` on the pattern's row view,
  the crosses by ``torch.linalg.cross``, norms as sqrt of the summed
  squares, the pattern updated in place row by row, magnitudes by
  ``torch.linalg.vector_norm`` and their population std. One rounding
  each, so on one device the result is the same bits as any
  implementation that keeps that order and those shapes.

It imports nothing but torch, numpy and the SpinTorque reference (for its
seed derivation, device parameters and pulse energy). It receives only
what the benchmark hands to both sides (the configuration's numbers, the
seed, the actions) and, where it follows the program step by step, the
state a step started from. Matrix products run without TF32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from perfbench.reference import spintorque as st

Tensor = torch.Tensor

GAMMA = st.GAMMA
MU0 = st.MU0
ALPHA = 0.01  # upstream's hard-coded damping of the array's device law


class Env(NamedTuple):
    """The configuration of the env, from the configuration file."""

    rows: int
    cols: int
    max_steps: int
    max_current: float
    max_duration: float
    success_threshold: float
    energy_penalty_weight: float
    autoreset: bool
    device: st.Device
    coupling: Tensor  # (N, N)
    target: Tensor  # (N, 3)
    easy_axis: Tensor  # (3,), unit
    h_k: Tensor  # the anisotropy field's magnitude


def coupling_matrix(rows: int, cols: int, strength: float) -> np.ndarray:
    """Dipolar coupling strength / r^3 between devices on a unit grid, in
    float64."""
    n = rows * cols
    c = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                (ir, ic), (jr, jc) = divmod(i, cols), divmod(j, cols)
                d = np.sqrt((ir - jr) ** 2 + (ic - jc) ** 2)
                c[i, j] = strength / d**3
    return c


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def make_env(config: Dict, device) -> Env:
    """The reference's view of a configuration file."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e = config["env"]
    if (e["device_type"], e["action_mode"], e["observation_mode"], e["coupling_update"],
            e["coupling_type"], e["include_coupling"], e["dtype"]) != (
            "stt_mram", "individual", "array", "sequential", "dipolar", True, "float32"):
        raise ValueError("the reference covers STT-MRAM crossbars with dipolar coupling, "
                         "individual actions, array observations, the sequential sweep and "
                         "float32")
    dtype = torch.float32
    d = st.make_device(config["device_params"], dtype, device)
    rows, cols = int(e["rows"]), int(e["cols"])
    target = np.asarray(config["target_pattern"], float).reshape(rows * cols, 3)
    easy = d.easy_axis
    return Env(
        rows=rows, cols=cols, max_steps=int(e["max_steps"]),
        max_current=float(e["max_current"]), max_duration=float(e["max_duration"]),
        success_threshold=float(e["success_threshold"]),
        energy_penalty_weight=float(e["energy_penalty_weight"]), autoreset=bool(e["autoreset"]),
        device=d,
        coupling=torch.as_tensor(coupling_matrix(rows, cols, float(e["coupling_strength"])),
                                 dtype=dtype, device=device),
        target=torch.as_tensor(target, dtype=dtype, device=device),
        easy_axis=easy / _norm(easy),
        h_k=2.0 * d.uniaxial_anisotropy / (MU0 * d.saturation_magnetization),
    )


class State(NamedTuple):
    pattern: Tensor  # (B, N, 3)
    target: Tensor  # (B, N, 3)
    step: Tensor  # (B,) int32
    total_energy: Tensor
    episode_return: Tensor


def sample_pattern(env: Env, generator: torch.Generator, batch: int, device) -> Tensor:
    """Random unit magnetizations: normals over their norm."""
    m = torch.randn((batch, env.rows * env.cols, 3), generator=generator, dtype=torch.float32,
                    device=device)
    return m / _norm(m)


def reset(env: Env, seed: int, batch: int, device) -> State:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    zeros = torch.zeros((batch,), dtype=torch.float32, device=device)
    return State(sample_pattern(env, g, batch, device),
                 env.target.expand(batch, env.rows * env.cols, 3),
                 torch.zeros((batch,), dtype=torch.int32, device=device), zeros, zeros)


def decode(env: Env, action: Tensor):
    """(pulsed-device mask (B, N), current (B,), duration (B,))."""
    n = env.rows * env.cols
    index = torch.arange(n, device=action.device)
    sel = torch.clamp(action[:, 0].to(torch.int32), 0, n - 1)
    mask = index[None, :] == sel[:, None]
    current = torch.clamp(action[:, 1], -env.max_current, env.max_current)
    duration = torch.clamp(action[:, 2], 1e-12, env.max_duration)
    return mask, current, duration


def resistance(d: st.Device, mx: Tensor, my: Tensor, mz: Tensor) -> Tensor:
    """STT-MRAM: R = R_p (1 + TMR (1 - cos) / 2), floored at R_p / 2."""
    ref = d.reference_magnetization
    rx, ry, rz = ref[..., 0], ref[..., 1], ref[..., 2]
    norm = torch.sqrt(rx * rx + ry * ry + rz * rz)
    cos_theta = mx * (rx / norm) + my * (ry / norm) + mz * (rz / norm)
    r_p, r_ap = d.resistance_parallel, d.resistance_antiparallel
    tmr = (r_ap - r_p) / r_p
    r = r_p * (1.0 + tmr * (1.0 - cos_theta) / 2.0)
    return torch.maximum(r, r_p * 0.5)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def device_law(m: Tensor, h: Tensor, current: Tensor, duration: Tensor) -> Tensor:
    """One slope, ten Euler substeps of dt / 10 with a renormalization after
    each; a device driven by |I| <= 1e-12 stays exactly put."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=m.dtype, device=m.device).expand_as(m)
    tau = 0.1 * current[:, None] * _cross(m, _cross(m, z))
    dmdt = -GAMMA * _cross(m, h)
    dmdt = dmdt + ALPHA * _cross(m, dmdt)
    dmdt = dmdt + tau
    dt = (duration / 10.0)[:, None]
    out = m
    for _ in range(10):
        out = out + dmdt * dt
        out = out / _norm(out)
    return torch.where((current.abs() > 1e-12)[:, None], out, m)


def sweep(env: Env, pattern: Tensor, mask: Tensor, current: Tensor, duration: Tensor):
    """(pattern after the sweep, energy (B,)): device d reads the devices
    before it already updated."""
    held = pattern
    pattern = st.flush_subnormal(pattern)
    energy = torch.zeros_like(current)
    e = env.easy_axis
    for d in range(env.rows * env.cols):
        m_d = pattern[:, d, :]
        h = env.h_k * (m_d @ e)[:, None] * e[None, :]
        h = h + torch.einsum("n,bnc->bc", env.coupling[d], pattern)
        m_new = device_law(m_d, h, current, duration)
        pulsed = mask[:, d]
        m_out = torch.where(pulsed[:, None], m_new, m_d)
        r = resistance(env.device, m_d[:, 0], m_d[:, 1], m_d[:, 2])
        energy = energy + torch.where(
            pulsed, st.pulse_energy(current, duration, r, env.device.area), 0.0)
        pattern[:, d, :] = m_out  # last: m_d views this row
    moved = mask & (current.abs() > 1e-12)[:, None]
    return torch.where(moved[..., None], pattern, held), energy


def similarity(pattern: Tensor, target: Tensor) -> Tensor:
    return (pattern * target).sum(-1).mean(-1)


def observe(env: Env, pattern: Tensor, target: Tensor) -> Tensor:
    b = pattern.shape[0]
    return torch.cat([pattern.reshape(b, env.rows, env.cols, 3),
                      target.reshape(b, env.rows, env.cols, 3)], dim=-1)


def reward(env: Env, is_success, step_energy, sim, improvement, magnitudes) -> Tensor:
    total = 10.0 * torch.where(is_success, 10.0, sim * 5.0)
    total = total + -env.energy_penalty_weight * (-step_energy / 1e-12)
    total = total + 1.0 * improvement
    return total + 2.0 * torch.clamp_min(1.0 - magnitudes.std(-1, correction=0), 0.0)


class StepOut(NamedTuple):
    pattern: Tensor  # after the sweep, before the auto-reset
    obs: Tensor
    reward: Tensor
    terminated: Tensor
    truncated: Tensor
    next_state: State


def step(env: Env, s: State, action: Tensor, seed: int, counter: int) -> StepOut:
    """One step of the whole batch from state ``s``; ``seed`` and
    ``counter`` key the auto-reset draws."""
    mask, current, duration = decode(env, action)
    prev = similarity(s.pattern, s.target)
    pattern, step_energy = sweep(env, s.pattern, mask, current, duration)
    total_energy = s.total_energy + step_energy
    n_step = s.step + 1
    sim = similarity(pattern, s.target)
    improvement = sim - prev
    is_success = sim >= env.success_threshold
    rew = reward(env, is_success, step_energy, sim, improvement,
                 torch.linalg.vector_norm(pattern, dim=-1))
    episode_return = s.episode_return + rew
    terminated = is_success
    truncated = n_step >= env.max_steps
    done = terminated | truncated
    obs = observe(env, pattern, s.target)
    nxt = State(pattern, s.target, n_step, total_energy, episode_return)
    if env.autoreset:
        fresh = sample_pattern(env, st.reset_generator(seed, counter, pattern.device),
                               pattern.shape[0], pattern.device)
        nxt = State(torch.where(done[:, None, None], fresh, pattern), s.target,
                    torch.where(done, 0, n_step), torch.where(done, 0.0, total_energy),
                    torch.where(done, 0.0, episode_return))
        obs = torch.where(done[:, None, None, None], observe(env, nxt.pattern, nxt.target), obs)
    return StepOut(pattern, obs, rew, terminated, truncated, nxt)
