"""Plain reference of one SpinTorque-v0 env step, in PyTorch.

A frozen, self-contained copy of the arithmetic that the env step under
test is specified to perform: the action clamps, the dt law, the LLGS
right-hand side, RK4 with the per-substep thermal field, Philox4x32-10 and
Box-Muller normals keyed as the env keys them, the normalization with its
+z fallback and the subnormal flush, the failed-solve mask, the pulse's
Joule energy at the pre-step resistance, the 12-dim observation, the
default composite reward, termination, truncation and the auto-reset
draws. Every operation is a plain tensor operation in the order the
specification gives, one rounding each, so on one device the result is
the same bits as any implementation that keeps that order.

It imports nothing but torch and numpy. It receives only what the
benchmark hands to both sides (the configuration's numbers, the seed, the
actions) and, where it follows the program step by step, the state a step
started from.

The pulse takes a key and a global env index per row, so the rows of
several steps (each with its own key) integrate in one loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

GAMMA = 2.21e5  # gyromagnetic ratio of the solver (m / (A s))
MU0 = 4.0 * np.pi * 1e-7
KB_SOLVER = 1.38e-23  # the truncated Boltzmann constant of the solver

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
RESET_STREAM = 1
NOISE_CHUNK = 64


# ----------------------------------------------------------------- keys


def derive_seed(seed: int, counter: int) -> int:
    """SplitMix64 of seed + (counter + 1) * golden gamma."""
    z = (seed + (counter + 1) * 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def reset_generator(seed: int, counter: int, device) -> torch.Generator:
    """The generator of step ``counter``'s auto-reset draws."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(derive_seed(seed, counter), RESET_STREAM))
    return g


# --------------------------------------------------------------- Philox


def _mulhilo(a: int, b: Tensor) -> Tuple[Tensor, Tensor]:
    p_lo = (b & 0xFFFF) * a
    p_hi = (b >> 16) * a
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: Tensor, k1: Tensor):
    """Philox4x32-10 on int64 tensors holding uint32 words; the key words
    are tensors too (one key per row)."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(w: Tensor, dtype) -> Tensor:
    return (w & 0x7FFFFF).to(dtype) * (2.0**-23)


def _cos_sin_2pi(u: Tensor) -> Tuple[Tensor, Tensor]:
    """(cos, sin) of 2 pi u by a quadrant fold and the Cephes float32
    polynomials."""
    q = u * 4.0
    k = torch.floor(q + 0.5)
    x = (q - k) * (0.5 * math.pi)
    z = x * x
    cp = ((2.443315711809948e-5 * z - 1.388731625493765e-3) * z
          + 4.166664568298827e-2) * (z * z) - 0.5 * z + 1.0
    sp = (((-1.9515295891e-4 * z + 8.3321608736e-3) * z
           - 1.6666654611e-1) * z) * x + x
    kb = k.to(torch.int32) & 3
    swap = (kb & 1) == 1
    c = torch.where(swap, sp, cp)
    s = torch.where(swap, cp, sp)
    c = torch.where((kb == 1) | (kb == 2), -c, c)
    s = torch.where((kb == 2) | (kb == 3), -s, s)
    return c, s


def _normal_pair(w1: Tensor, w2: Tensor, dtype) -> Tuple[Tensor, Tensor]:
    u1 = 1.0 - _uniform(w1, dtype)
    u2 = _uniform(w2, dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, s = _cos_sin_2pi(u2)
    return r * c, r * s


def substep_normals(keys: Tuple[Tensor, Tensor], env_index: Tensor, substeps: Tensor,
                    dtype) -> Tensor:
    """(C, 4, N) normals of one Philox call per env and substep: counter
    (env index, substep, 0, 0) under each row's key."""
    k0, k1 = keys
    c0 = env_index.to(torch.int64)[None, :]
    c1 = substeps.to(torch.int64)[:, None]
    c3 = torch.zeros_like(c0)
    c2 = torch.full_like(c0, 0)
    words = philox4x32_10(c0, c1, c2, c3, k0[None, :], k1[None, :])
    a0, a1 = _normal_pair(words[0], words[1], dtype)
    b0, b1 = _normal_pair(words[2], words[3], dtype)
    return torch.stack([a0, a1, b0, b1], dim=1)


# ------------------------------------------------------------- physics


@dataclasses.dataclass(frozen=True)
class Device:
    """The device's parameters as 0-dim tensors ((3,) for the axes)."""

    volume: Tensor
    area: Tensor
    saturation_magnetization: Tensor
    damping: Tensor
    uniaxial_anisotropy: Tensor
    polarization: Tensor
    resistance_parallel: Tensor
    resistance_antiparallel: Tensor
    easy_axis: Tensor
    reference_magnetization: Tensor


def make_device(params: Dict, dtype, device) -> Device:
    """Tensors of ``dtype`` on ``device`` from the configuration's numbers."""
    fields = [f.name for f in dataclasses.fields(Device)]
    return Device(**{k: torch.as_tensor(np.asarray(params[k]), dtype=dtype, device=device)
                     for k in fields})


def _unit(v: Tensor):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    norm = torch.sqrt(x * x + y * y + z * z)
    return x / norm, y / norm, z / norm


class Coefficients(NamedTuple):
    ms: Tensor
    alpha: Tensor
    ex: Tensor
    ey: Tensor
    ez: Tensor
    h_k: Tensor
    neg_gamma_eff: Tensor
    stt: Tensor


def coefficients(current: Tensor, d: Device) -> Coefficients:
    alpha = d.damping
    ms = d.saturation_magnetization
    ex, ey, ez = _unit(d.easy_axis)
    h_k = (2.0 * d.uniaxial_anisotropy) / (MU0 * ms)
    stt = d.polarization * current / (ms * d.volume)
    stt = torch.where(current.abs() > 1e-12, stt, 0.0)
    gamma_eff = torch.full_like(alpha, GAMMA) / (1.0 + alpha * alpha)
    return Coefficients(ms, alpha, ex, ey, ez, h_k, -gamma_eff, stt)


def thermal_sigma(d: Device, temperature: float, like: Tensor) -> Tensor:
    """Brown's field amplitude without the 1/sqrt(dt) ('reference' mode)."""
    denom = MU0 * d.saturation_magnetization * d.volume * GAMMA
    sigma = torch.sqrt(2.0 * d.damping * KB_SOLVER * temperature / denom)
    sigma = torch.broadcast_to(sigma, like.shape)
    return sigma if temperature > 0.0 else torch.zeros_like(sigma)


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _rhs(mx, my, mz, c: Coefficients, h_th):
    """dm/dt = -gamma/(1+alpha^2) [m x H + alpha m x (m x H)] + stt m x (m x e),
    H = h_k (m . e) e - Ms m_z z + H_thermal."""
    m_dot_e = mx * c.ex + my * c.ey + mz * c.ez
    anis = c.h_k * m_dot_e
    hx, hy, hz = anis * c.ex, anis * c.ey, anis * c.ez
    hz = hz - c.ms * mz
    if h_th is not None:
        hx, hy, hz = hx + h_th[0], hy + h_th[1], hz + h_th[2]
    ux, uy, uz = _cross(mx, my, mz, c.ex, c.ey, c.ez)
    vx, vy, vz = _cross(mx, my, mz, ux, uy, uz)
    px, py, pz = _cross(mx, my, mz, hx, hy, hz)
    dx, dy, dz = _cross(mx, my, mz, px, py, pz)
    return (c.neg_gamma_eff * (px + c.alpha * dx) + c.stt * vx,
            c.neg_gamma_eff * (py + c.alpha * dy) + c.stt * vy,
            c.neg_gamma_eff * (pz + c.alpha * dz) + c.stt * vz)


def _rk4_increment(mx, my, mz, dt, c, h_th):
    six = torch.full_like(dt, 6.0)
    k1x, k1y, k1z = _rhs(mx, my, mz, c, h_th)
    k1x, k1y, k1z = dt * k1x, dt * k1y, dt * k1z
    k2x, k2y, k2z = _rhs(mx + k1x / 2, my + k1y / 2, mz + k1z / 2, c, h_th)
    k2x, k2y, k2z = dt * k2x, dt * k2y, dt * k2z
    k3x, k3y, k3z = _rhs(mx + k2x / 2, my + k2y / 2, mz + k2z / 2, c, h_th)
    k3x, k3y, k3z = dt * k3x, dt * k3y, dt * k3z
    k4x, k4y, k4z = _rhs(mx + k3x, my + k3y, mz + k3z, c, h_th)
    k4x, k4y, k4z = dt * k4x, dt * k4y, dt * k4z
    return ((k1x + 2 * k2x + 2 * k3x + k4x) / six,
            (k1y + 2 * k2y + 2 * k3y + k4y) / six,
            (k1z + 2 * k2z + 2 * k3z + k4z) / six)


def normalize_with_fallback(mx, my, mz):
    """m / |m|; a non-finite or near-zero vector becomes +z."""
    norm = torch.sqrt(mx * mx + my * my + mz * mz)
    finite = torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(mz)
    ok = finite & (norm >= 1e-12)
    safe = torch.where(ok, norm, 1.0)
    nx, ny, nz = mx / safe, my / safe, mz / safe
    ok = ok & torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz)
    return torch.where(ok, nx, 0.0), torch.where(ok, ny, 0.0), torch.where(ok, nz, 1.0)


def flush_subnormal(x: Tensor) -> Tensor:
    """Subnormals become a zero of their sign."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, x * 0.0, x)


def dt_law(span: Tensor, max_step: float, max_substeps: int) -> Tuple[Tensor, Tensor]:
    """dt0 = min(max_step, span / 100), n = max(10, floor(span / dt0)) capped
    at ``max_substeps``, dt = span / n. Divisions are tensor by tensor."""
    hundred = torch.full_like(span, 100.0)
    dt0 = torch.minimum(torch.full_like(span, max_step), span / hundred)
    n = torch.clamp_min(torch.floor(span / dt0).to(torch.int32), 10)
    n = torch.clamp_max(n, max_substeps)
    return span / n.to(span.dtype), n


def max_substeps_for(max_duration: float, max_step: float) -> int:
    return max(10, int(math.ceil(max_duration / min(max_step, max_duration / 100.0))) + 1)


class Pulse(NamedTuple):
    m: Tuple[Tensor, Tensor, Tensor]
    failed: Tensor


def pulse(m0, span: Tensor, current: Tensor, d: Device, *, thermal: bool, temperature: float,
          keys: Tuple[Tensor, Tensor] | None, env_index: Tensor | None, max_step: float,
          max_substeps: int, graph: bool = False) -> Pulse:
    """RK4 over each row's substeps under the dt law; rows past their n hold
    their state. With ``thermal`` one field realization (three normals of
    one Philox call) per substep, held over the four stages.

    The substeps run in chunks of ``NOISE_CHUNK``, each chunk's normals
    drawn at its start. With ``graph`` (a CUDA device) the first chunk runs
    eagerly and is then captured as a CUDA graph that the later chunks
    replay: the same kernels on the same buffers, launched by the graph
    rather than one by one from the host."""
    mx, my, mz = (flush_subnormal(x) for x in m0)
    dt, n = dt_law(span, max_step, max_substeps)
    n_max = int(n.max()) if n.numel() else 0
    c = coefficients(current, d)
    sigma = thermal_sigma(d, temperature, dt) if thermal else None
    m = [mx, my, mz]
    failed = [torch.zeros(mx.shape, dtype=torch.bool, device=mx.device)]
    base = torch.zeros((), dtype=torch.int64, device=mx.device)
    offsets = torch.arange(NOISE_CHUNK, device=mx.device)

    def chunk():
        """NOISE_CHUNK substeps from substep ``base`` on; advances ``base``."""
        normals = None
        if sigma is not None:
            normals = substep_normals(keys, env_index, base + offsets, mx.dtype)
        x, y, z = m
        f = failed[0]
        for j in range(NOISE_CHUNK):
            h_th = None if normals is None else tuple(sigma * normals[j][k] for k in range(3))
            dx, dy, dz = _rk4_increment(x, y, z, dt, c, h_th)
            nx, ny, nz = (flush_subnormal(v) for v in
                          normalize_with_fallback(x + dx, y + dy, z + dz))
            active = (base + j) < n
            zero_row = active & (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
            x = torch.where(active, nx, x)
            y = torch.where(active, ny, y)
            z = torch.where(active, nz, z)
            f = f | zero_row
        return x, y, z, f

    chunks = -(-n_max // NOISE_CHUNK)
    if not graph:
        for _ in range(chunks):
            *m, failed[0] = chunk()
            base += NOISE_CHUNK
        return Pulse(tuple(m), failed[0])
    # Static buffers that the captured chunk reads and writes in place.
    m = [v.clone() for v in m]
    failed = [failed[0].clone()]

    def chunk_in_place():
        *out, f = chunk()
        for buf, v in zip(m + failed, out + [f]):
            buf.copy_(v)
        base.add_(NOISE_CHUNK)

    if chunks:
        chunk_in_place()
    if chunks > 1:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            chunk_in_place()
        for _ in range(chunks - 1):
            g.replay()
    return Pulse(tuple(m), failed[0])


# ------------------------------------------------------------------ env


class Env(NamedTuple):
    """The configuration of the env, from the configuration file."""

    max_steps: int
    max_current: float
    max_duration: float
    temperature: float
    include_thermal: bool
    success_threshold: float
    energy_penalty_weight: float
    autoreset: bool
    max_step: float
    max_substeps: int
    device: Device
    targets: Tensor  # (K, 3)


def make_env(config: Dict, device) -> Env:
    """The reference's view of a configuration file."""
    e = config["env"]
    if (e["method"], e["rk4_noise"], e["noise_mode"], e["dtype"], e["action_mode"],
            e["observation_mode"], e["device_type"]) != (
            "rk4", "per_substep", "reference", "float32", "continuous", "vector", "stt_mram"):
        raise ValueError("the reference covers RK4 with a per-substep 'reference' field, "
                         "float32, continuous actions, vector observations, STT-MRAM")
    dtype = torch.float32
    targets = np.asarray(config["target_states"], float)
    targets = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
    max_step = float(config["integrator"]["max_step"])
    return Env(
        max_steps=int(e["max_steps"]), max_current=float(e["max_current"]),
        max_duration=float(e["max_duration"]), temperature=float(e["temperature"]),
        include_thermal=bool(e["include_thermal"]),
        success_threshold=float(e["success_threshold"]),
        energy_penalty_weight=float(e["energy_penalty_weight"]), autoreset=bool(e["autoreset"]),
        max_step=max_step, max_substeps=max_substeps_for(float(e["max_duration"]), max_step),
        device=make_device(config["device_params"], dtype, device),
        targets=torch.as_tensor(targets, dtype=dtype, device=device),
    )


class State(NamedTuple):
    m: Tensor  # (B, 3)
    target: Tensor  # (B, 3)
    step: Tensor  # (B,) int32
    total_energy: Tensor
    last_current: Tensor
    last_duration: Tensor
    episode_return: Tensor


def sample_states(env: Env, generator: torch.Generator, batch: int, device):
    """A batch of random unit magnetizations and targets."""
    m = torch.randn((batch, 3), generator=generator, dtype=torch.float32, device=device)
    norm = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    m = m / torch.clamp_min(norm, 1e-12)
    idx = torch.randint(0, env.targets.shape[0], (batch,), generator=generator, device=device)
    return m, env.targets[idx]


def reset(env: Env, seed: int, batch: int, device) -> State:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m, target = sample_states(env, g, batch, device)

    def zeros():
        return torch.zeros((batch,), dtype=torch.float32, device=device)

    return State(m, target, torch.zeros((batch,), dtype=torch.int32, device=device),
                 zeros(), zeros(), zeros(), zeros())


def decode(env: Env, action: Tensor) -> Tuple[Tensor, Tensor]:
    """(B, 2) [current, duration] with the NaN scrub and the clamps."""
    current, duration = action[..., 0], action[..., 1]
    bad = ~(torch.isfinite(current) & torch.isfinite(duration))
    current = torch.where(bad, 0.0, current)
    duration = torch.where(bad, 1e-12, duration)
    current = torch.clamp(current, -env.max_current, env.max_current)
    duration = torch.clamp(duration, 1e-12, env.max_duration)
    return current, duration


def resistance(env: Env, m: Tensor) -> Tensor:
    """STT-MRAM: R = R_p (1 + TMR (1 - cos) / 2), floored at R_p / 2."""
    d = env.device
    rx, ry, rz = _unit(d.reference_magnetization)
    cos_theta = m[..., 0] * rx + m[..., 1] * ry + m[..., 2] * rz
    r_p, r_ap = d.resistance_parallel, d.resistance_antiparallel
    tmr = (r_ap - r_p) / r_p
    r = r_p * (1.0 + tmr * (1.0 - cos_theta) / 2.0)
    return torch.maximum(r, r_p * 0.5)


def pulse_energy(current: Tensor, duration: Tensor, r: Tensor, area: Tensor) -> Tensor:
    """E = (J R A)^2 / R * t, 0 where |J| <= 1e-12."""
    voltage = current * r * area
    e = voltage * voltage / r * duration
    return torch.where(current.abs() > 1e-12, e, 0.0)


def observe(env: Env, s: State) -> Tensor:
    """[m, target, R/R_p, T/300, steps left, E/pJ, J/J_max, t/t_max]."""
    r = resistance(env, s.m)
    r0 = env.device.resistance_parallel
    steps_left = ((env.max_steps - s.step).float() / env.max_steps).to(torch.float32)
    return torch.cat([
        s.m, s.target, (r / r0)[..., None],
        torch.full_like(r, env.temperature / 300.0)[..., None], steps_left[..., None],
        (s.total_energy / 1e-12)[..., None], (s.last_current / env.max_current)[..., None],
        (s.last_duration / env.max_duration)[..., None],
    ], dim=-1)


def reward(env: Env, is_success, step_energy, improvement, alignment) -> Tensor:
    """10 x success(10) - w x (-E/pJ) + 1 x improvement - 2 x 0, summed in
    that order, NaN to -1, clamped to +-1e6."""
    total = 10.0 * torch.where(is_success, 10.0, 0.0).to(alignment.dtype)
    total = total + -env.energy_penalty_weight * (-step_energy / 1e-12)
    total = total + 1.0 * improvement
    total = total + -2.0 * torch.zeros_like(alignment)
    return torch.clamp(torch.nan_to_num(total, nan=-1.0), -1e6, 1e6)


class StepOut(NamedTuple):
    m_new: Tensor  # after the pulse, before the auto-reset
    failed: Tensor
    obs: Tensor
    reward: Tensor
    terminated: Tensor
    truncated: Tensor
    next_state: State


def finish_step(env: Env, s: State, current: Tensor, duration: Tensor, p: Pulse,
                resets: Tuple[Tensor, Tensor] | None) -> StepOut:
    """Everything of a step after its pulse; ``resets`` holds each row's
    auto-reset magnetization and target."""
    mx, my, mz = p.m
    norm = torch.sqrt(mx * mx + my * my + mz * mz)
    m_int = torch.stack([mx / norm, my / norm, mz / norm], dim=-1)
    m_new = torch.where(p.failed[:, None], s.m, m_int)
    prev_alignment = torch.sum(s.m * s.target, dim=-1)
    r_pre = resistance(env, s.m)
    step_energy = pulse_energy(current, duration, r_pre, env.device.area)
    total_energy = s.total_energy + step_energy
    step = s.step + 1
    alignment = torch.sum(m_new * s.target, dim=-1)
    improvement = alignment - prev_alignment
    is_success = alignment >= env.success_threshold
    terminated = is_success
    truncated = step >= env.max_steps
    done = terminated | truncated
    mid = State(m_new, s.target, step, total_energy, current, duration, s.episode_return)
    obs_step = observe(env, mid)
    rew = reward(env, is_success, step_energy, improvement, alignment)
    episode_return = s.episode_return + rew
    if resets is None:
        nxt = mid._replace(episode_return=episode_return)
        return StepOut(m_new, p.failed, obs_step, rew, terminated, truncated, nxt)
    m_reset, t_reset = resets
    d3 = done[:, None]
    nxt = State(
        m=torch.where(d3, m_reset, m_new),
        target=torch.where(d3, t_reset, s.target),
        step=torch.where(done, 0, step),
        total_energy=torch.where(done, 0.0, total_energy),
        last_current=torch.where(done, 0.0, current),
        last_duration=torch.where(done, 0.0, duration),
        episode_return=torch.where(done, 0.0, episode_return),
    )
    obs = torch.where(d3, observe(env, nxt), obs_step)
    return StepOut(m_new, p.failed, obs, rew, terminated, truncated, nxt)


class StepInput(NamedTuple):
    """One step to follow: the state it started from, its action, the
    env's seed and the step's counter, the batch it belongs to and which of
    its rows to compute."""

    state: State
    action: Tensor  # (rows, 2)
    seed: int
    counter: int
    batch: int
    rows: Tensor  # (rows,) int64 indices into the batch


def steps(env: Env, inputs: Sequence[StepInput], graph: bool = False) -> StepOut:
    """The reference outputs of several steps, their rows one after another
    in the order of ``inputs``: one pulse loop over all the rows (each keyed
    by its own step), each step's auto-reset draws of its whole batch, then
    the rest of the step over all the rows at once."""
    device = inputs[0].action.device
    current, duration = decode(env, torch.cat([x.action for x in inputs]))
    state = State(*(torch.cat([getattr(x.state, f) for x in inputs]) for f in State._fields))
    keys = env_index = None
    if env.include_thermal:
        words = [derive_seed(x.seed, x.counter) for x in inputs]  # each pulse's Philox key
        sizes = [len(x.rows) for x in inputs]
        keys = tuple(torch.cat([torch.full((size,), part(w), dtype=torch.int64) for w, size in
                                zip(words, sizes)]).to(device)
                     for part in (lambda w: w & MASK32, lambda w: w >> 32))
        env_index = torch.cat([x.rows for x in inputs]).to(device)
    p = pulse(state.m.t().contiguous().unbind(0), duration, current, env.device,
              thermal=env.include_thermal, temperature=env.temperature, keys=keys,
              env_index=env_index, max_step=env.max_step, max_substeps=env.max_substeps,
              graph=graph)
    resets = None
    if env.autoreset:
        drawn = [sample_states(env, reset_generator(x.seed, x.counter, device), x.batch, device)
                 for x in inputs]
        resets = tuple(torch.cat([d[k][x.rows.to(device)] for d, x in zip(drawn, inputs)])
                       for k in range(2))
    return finish_step(env, state, current, duration, p, resets)
