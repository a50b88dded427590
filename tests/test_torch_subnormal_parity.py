"""The port's plain-torch state loops against the JAX package's where XLA's
flush of float subnormals decides the outcome.

XLA on the CPU (as on a TPU) flushes subnormal floats to zeros of their
sign, inputs and results alike; IEEE arithmetic, which torch follows,
keeps them. A state at
a pole whose transverse components are subnormal is a fixed point to XLA,
while an unstable integration grows the kept components until the state
leaves its pole. The port flushes the carried state
(``physics.integrator.flush_subnormal``) where that decides the result:

  * The pulse's plain loop and trajectory on entry and after every
    substep: from every sign of subnormal or decaying transverse parts at
    both poles, each component's sign bit is JAX's.
  * ``integrate_adaptive`` (RK45, midpoint, Radau) on entry and after
    every accepted update. From the -z pole with
    (1e-38, 1e-38) transverse parts under a destabilizing current, each
    method ends at the pole with JAX's accepted and rejected step counts;
    under a weakly stabilizing current a state of 1e-30 decays through the
    subnormal range to exactly the pole, as in JAX. m is held bit for bit
    by magnitude, and by sign bit in the signed-zero cases.
  * ``AdaptiveLLGSSolver.solve``, RK45 by default, as the JAX facade.
  * The array env's two sweeps compute from the flushed pattern, and the
    devices they do not move keep their input: a pattern of +-z devices
    with subnormal transverse parts stays put for 24 steps of +-2e6 A/m^2,
    in both coupling modes, as in JAX. The pattern is held bit for bit by
    magnitude, and by sign bit with undriven arrays among them; obs, reward and info at rtol 1e-5, the float32 tolerance of
    ``tests/test_torch_array_env.py``.
  * The racetrack needs no flush: from subnormal velocities, with the
    skyrmions so far off the centerline that every pinning well's
    exp(-dist / r) is subnormal, it agrees with JAX at the tolerances of
    ``tests/test_torch_skyrmion_env.py`` in float64, and at rtol 1e-5 in
    float32. A pinning force is masked to 0 beyond 3 r, and a kept
    subnormal velocity moves a skyrmion by less than 1e-48 m.

Everything runs in float32 unless a case says otherwise, the JAX side
jitted on the CPU.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.envs.array import ArrayEnvConfig as JArrayConfig
from spintorque_tpu.envs.array import SpinTorqueArrayEnv as JArrayEnv
from spintorque_tpu.envs.skyrmion import SkyrmionEnvConfig as JSkyrmionConfig
from spintorque_tpu.envs.skyrmion import SkyrmionRacetrackEnv as JSkyrmionEnv
from spintorque_tpu.physics import AdaptiveLLGSSolver as JAdaptiveLLGSSolver
from spintorque_tpu.physics import IntegratorConfig as JIntegratorConfig
from spintorque_tpu.physics import integrate_adaptive as jax_integrate_adaptive
from spintorque_tpu.physics import integrate_pulse as jax_integrate_pulse
from spintorque_tpu.physics.solver import params_from_dict as jax_params_from_dict
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import (
    ArrayEnvConfig,
    SkyrmionEnvConfig,
    SkyrmionRacetrackEnv,
    SpinTorqueArrayEnv,
)
from spintorque_tpu_torch.physics import (
    AdaptiveLLGSSolver,
    IntegratorConfig,
    integrate_adaptive,
    integrate_pulse_plain,
    integrate_pulse_trajectory,
)
from spintorque_tpu_torch.physics.solver import params_from_dict

torch.set_num_threads(1)

# The device and current of the pulse's subnormal test
# (tests/test_torch_research_tier.py): the current destabilizes -z.
DEVICE = dict(volume=1e-24, saturation_magnetization=800e3, damping=0.01,
              uniaxial_anisotropy=8e5, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]))
POLE = (1e-38, 1e-38, -1.0)
DESTABILIZING = -2.7e-7
METHODS = ("rk45", "midpoint", "radau")
F32 = 1e-5  # rtol of a float32 comparison


def _same_magnitudes(got, want, name):
    got, want = np.abs(np.asarray(got)), np.abs(np.asarray(want))
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _adaptive_both(m0, span, current, method):
    m = [np.array([x], np.float32) for x in m0]
    args = (np.array([span], np.float32), np.array([current], np.float32))
    kw = dict(max_steps=4000, method=method)
    want = jax.jit(lambda: jax_integrate_adaptive(
        tuple(jnp.asarray(x) for x in m), *map(jnp.asarray, args),
        jax_params_from_dict(DEVICE), **kw))()
    got = integrate_adaptive(tuple(torch.from_numpy(x) for x in m),
                             *map(torch.from_numpy, args),
                             params_from_dict(DEVICE, device="cpu"), **kw)
    return got, want


def _check_adaptive(got, want):
    for k in range(3):
        _same_magnitudes(got.m[k].numpy(), want.m[k], f"m[{k}]")
    assert int(got.n_steps[0]) == int(want.n_steps[0])
    assert int(got.n_rejected[0]) == int(want.n_rejected[0])
    assert bool(got.success[0]) == bool(want.success[0])


@pytest.mark.parametrize("span", [2.5e-10, 5e-9])
@pytest.mark.parametrize("method", METHODS)
def test_adaptive_pole_state_matches_jax(method, span):
    """Before the flush, RK45 left the pole (m_z = +0.927, 3992 steps,
    success False, where JAX ends at the pole in 28) and the midpoint
    carried its 1e-38 components on; Radau agreed."""
    got, want = _adaptive_both(POLE, span, DESTABILIZING, method)
    _check_adaptive(got, want)
    assert [abs(float(x[0])) for x in got.m] == [0.0, 0.0, 1.0]
    assert bool(got.success[0])


@pytest.mark.parametrize("method", METHODS)
def test_adaptive_decay_through_subnormals_matches_jax(method):
    """A state of 1e-30 off the -z pole under a weakly stabilizing current
    (2e-12 A/m^2, above the torque's 1e-12 cutoff) decays through the
    subnormal range: JAX and the port end at exactly the pole. Without the
    flush after each accepted update, RK45 and the midpoint kept
    subnormal components (down to 1.4e-45)."""
    got, want = _adaptive_both((1e-30, 1e-30, -1.0), 2.5e-10, 2e-12, method)
    _check_adaptive(got, want)
    assert [abs(float(x[0])) for x in got.m] == [0.0, 0.0, 1.0]


def test_adaptive_solver_facade_holds_the_pole():
    want = JAdaptiveLLGSSolver().solve(np.array(POLE), (0.0, 2.5e-10), DEVICE,
                                       current=DESTABILIZING)
    got = AdaptiveLLGSSolver(device="cpu").solve(np.array(POLE), (0.0, 2.5e-10), DEVICE,
                                                 current=DESTABILIZING)
    assert got["m"].dtype == torch.float32
    _same_magnitudes(got["m"].numpy(), want["m"], "m")
    assert np.abs(got["m"].numpy()).tolist() == [0.0, 0.0, 1.0]
    assert got["success"] and want["success"]
    assert int(got["n_steps"]) == int(want["n_steps"])
    assert int(got["n_rejected"]) == int(want["n_rejected"])


# ---------------------------------------------------------- signed zeros
# XLA's flush keeps the sign: a negative subnormal becomes -0, and the
# arithmetic on signed zeros that follows is IEEE's in both packages. Each
# case holds the port's sign bit per component to JAX's, with the
# magnitudes bit for bit.


def _signed_rows(mag):
    """(3, 8) float32 columns: (+-mag, +-mag, +-1) in every sign."""
    signs = np.array(list(itertools.product((1.0, -1.0), repeat=3)), np.float32).T
    return signs * np.array([[mag], [mag], [1.0]], np.float32)


def _same_signs(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    _same_magnitudes(got, want, name)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want), err_msg=f"{name}: sign")


# (start, |m_xy| at the start, span, current): "subnormal" starts flushed
# under the destabilizing current, every method a fixed point at its pole;
# "decay" starts normal under a weakly stabilizing current and decays
# through the subnormal range within the span.
PULSE_SIGN_CASES = {
    "subnormal": (1e-40, 2.5e-10, DESTABILIZING),
    "decay": (3e-38, 1e-9, 2e-12),
}


@pytest.mark.parametrize("method, start", [
    ("euler", "subnormal"), ("heun", "subnormal"), ("rk4", "subnormal"),
    ("euler", "decay"), ("heun", "decay"),
])
def test_pulse_signed_zeros_match_jax(method, start):
    """The plain loop and the trajectory from every sign of the transverse
    parts at both poles, against the jitted JAX pulse. JAX ends with -0 in
    3 of the 16 transverse components, which a flush to +0 loses.
    RK4 has no decay case: JAX's RK4 stage increments (0.35 |m_xy| a
    substep) underflow to 0 first, so its state stops at ~3e-38 and never
    enters the subnormal range, where the port's decays to the pole (the
    narrower flush, ROADMAP's recorded differences)."""
    mag, span, current = PULSE_SIGN_CASES[start]
    m = _signed_rows(mag)
    n = m.shape[1]
    span, current = np.full(n, span, np.float32), np.full(n, current, np.float32)
    kw = dict(method=method, max_substeps=1000)
    want = jax.jit(lambda: jax_integrate_pulse(
        tuple(jnp.asarray(x) for x in m), jnp.asarray(span), jnp.asarray(current),
        jax_params_from_dict(DEVICE), JIntegratorConfig(**kw)))()
    args = (tuple(torch.from_numpy(x) for x in m), torch.from_numpy(span),
            torch.from_numpy(current), params_from_dict(DEVICE, device="cpu"),
            IntegratorConfig(**kw))
    got = integrate_pulse_plain(*args)
    traj_result, traj = integrate_pulse_trajectory(*args)
    want_m = np.stack([np.asarray(x) for x in want.m])
    assert np.all(want_m[:2] == 0.0) and np.any(np.signbit(want_m[:2]))
    _same_signs(np.stack([x.numpy() for x in got.m]), want_m, "plain loop")
    _same_signs(np.stack([x.numpy() for x in traj_result.m]), want_m, "trajectory result")
    _same_signs(traj[-1].numpy(), want_m, "trajectory's last row")
    np.testing.assert_array_equal(got.n_substeps.numpy(), np.asarray(want.n_substeps))


def test_rk4_pulse_decays_what_jax_holds_just_above_the_subnormal_range():
    """The measured difference of the narrower flush. From transverse parts
    of +-3e-38 (normal, 2.6x the smallest normal) under 2e-12 A/m^2 for 1
    ns, jitted JAX's RK4 pulse keeps every one of them: its stage
    increments, ~0.35 |m_xy| a substep, are subnormal and flushed, so the
    state stops. The port flushes only the carried state, and its RK4
    decays them to exactly 0 (to zeros of either sign). JAX gives no one
    answer in this range: op by op its Heun pulse keeps them too over 250
    substeps, where jitted (``test_pulse_signed_zeros_match_jax``'s decay
    case) its fused multiply-adds decay them to 0 as the port does."""
    m = _signed_rows(3e-38)
    n = m.shape[1]

    def jax_pulse(method, span):
        return lambda: jax_integrate_pulse(
            tuple(jnp.asarray(x) for x in m), jnp.asarray(np.full(n, span, np.float32)),
            jnp.asarray(np.full(n, 2e-12, np.float32)), jax_params_from_dict(DEVICE),
            JIntegratorConfig(method=method, max_substeps=1000))

    want = jax.jit(jax_pulse("rk4", 1e-9))()
    got = integrate_pulse_plain(
        tuple(torch.from_numpy(x) for x in m), torch.full((n,), 1e-9), torch.full((n,), 2e-12),
        params_from_dict(DEVICE, device="cpu"), IntegratorConfig(method="rk4", max_substeps=1000))
    np.testing.assert_array_equal(np.stack([np.asarray(x) for x in want.m])[:2], m[:2])
    assert all(bool((x == 0).all()) for x in got.m[:2])
    with jax.disable_jit():
        heun = jax_pulse("heun", 2.5e-10)()
    np.testing.assert_array_equal(np.stack([np.asarray(x) for x in heun.m])[:2], m[:2])


@pytest.mark.parametrize("start", ["subnormal", "decay"])
@pytest.mark.parametrize("method", METHODS)
def test_adaptive_signed_zeros_match_jax(method, start):
    """``integrate_adaptive`` from every sign of the transverse parts at both
    poles: subnormal starts under the current that destabilizes each pole,
    and starts of 1e-30 decaying under 2e-12 A/m^2 toward each pole, as
    ``test_adaptive_decay_through_subnormals_matches_jax``. JAX ends every
    transverse component at +0 (each step adds to a sum that starts at +0).
    Radau with a flush on entry alone leaves +-1.4e-45 in two decaying
    rows."""
    mag, current = {"subnormal": (1e-40, DESTABILIZING), "decay": (1e-30, 2e-12)}[start]
    m = _signed_rows(mag)
    n = m.shape[1]
    span = np.full(n, 2.5e-10, np.float32)
    current = (-m[2] * current).astype(np.float32)  # -2.7e-7 at -z, +2.7e-7 at +z
    kw = dict(max_steps=4000, method=method)
    want = jax.jit(lambda: jax_integrate_adaptive(
        tuple(jnp.asarray(x) for x in m), jnp.asarray(span), jnp.asarray(current),
        jax_params_from_dict(DEVICE), **kw))()
    got = integrate_adaptive(tuple(torch.from_numpy(x) for x in m), torch.from_numpy(span),
                             torch.from_numpy(current), params_from_dict(DEVICE, device="cpu"),
                             **kw)
    want_m = np.stack([np.asarray(x) for x in want.m])
    assert np.all(want_m[:2] == 0.0)
    _same_signs(np.stack([x.numpy() for x in got.m]), want_m, "m")
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.n_rejected.numpy(), np.asarray(want.n_rejected))


# ---------------------------------------------------------------- the envs


def _state_to_numpy(js):
    leaves = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    stats = leaves.pop("reward_stats")
    d = jax.tree.map(np.asarray, leaves)
    d["reward_stats"] = {
        name: jax.tree.map(np.asarray,
                           {f.name: getattr(st, f.name) for f in dataclasses.fields(st)})
        for name, st in stats.items()
    }
    return d


def _close(got, want, name, rtol, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _check_info(tts, jts, keys, k, rtol, scale=None):
    scale = scale or {}
    _close(tts.reward, jts.reward, f"reward {k}", rtol, rtol)
    np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
    np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
    for key in keys:
        _close(tts.info[key], jts.info[key], f"info[{key}] {k}", rtol,
               rtol * scale.get(key, 1.0))
    for name in jts.info["reward_components"]:
        _close(tts.info["reward_components"][name], jts.info["reward_components"][name],
               f"reward component {name} {k}", rtol, rtol)


def _subnormals(rng, shape, dtype):
    """Subnormals of either sign, from the largest to the least of ``dtype``."""
    tiny = np.finfo(dtype).tiny
    least = np.finfo(dtype).smallest_subnormal
    mag = np.exp(rng.uniform(np.log(least), np.log(tiny), shape)).astype(dtype)
    return np.where(rng.random(shape) < 0.5, -mag, mag).astype(dtype)


ROWS, COLS, B = 3, 4, 4


def _subnormal_array(coupling_update, steps, currents=(-2e6, 2e6)):
    """The JAX and the port's 3 x 4 array envs from one state: rows of +z
    and -z devices whose transverse parts are subnormals of either sign
    (the 'global' mode, autoreset off), with ``steps`` actions of a current
    drawn from ``currents`` (A/m^2) for 5 ns. Returns (port env, port state, JAX state, the jitted
    JAX step, the actions)."""
    kw = dict(rows=ROWS, cols=COLS, dtype="float32", autoreset=False, action_mode="global",
              coupling_update=coupling_update)
    jenv = JArrayEnv(batch_size=B, config=JArrayConfig(**kw))
    tenv = SpinTorqueArrayEnv(batch_size=B, config=ArrayEnvConfig(**kw), device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    pattern = np.zeros((B, ROWS, COLS, 3), np.float32)
    pattern[..., :2] = _subnormals(rng, (B, ROWS, COLS, 2), np.float32)
    pattern[..., 2] = np.where(np.arange(ROWS) % 2 == 0, 1.0, -1.0)[None, :, None]
    jstate = jstate.replace(pattern=jnp.asarray(pattern.reshape(B, ROWS * COLS, 3)))
    tstate = convert.array_state_from_numpy(_state_to_numpy(jstate), device="cpu")
    currents = rng.choice(list(currents), (steps, B))
    actions = [np.stack([np.full(B, 5e-9), cur], -1).astype(np.float32) for cur in currents]
    return tenv, tstate, jstate, jax.jit(jenv.step), actions


@pytest.mark.parametrize("coupling_update", ["sequential", "simultaneous"])
def test_array_env_subnormal_pattern_matches_jax(coupling_update):
    """Rows of +z and -z devices (similarity 0 to the checkerboard target)
    with subnormal transverse parts, driven by +-2e6 A/m^2 on every device
    (the 'global' mode, 1 ns pulses). Every such device is a fixed point to
    XLA. Before the flush, the port's devices left their poles: by more
    than 0.1 from step 3 (simultaneous) and step 14 (sequential)."""
    tenv, tstate, jstate, step, actions = _subnormal_array(coupling_update, 24)
    for k, action in enumerate(actions):
        jstate, jts = step(jstate, jnp.asarray(action))
        tstate, tts = tenv.step(tstate, torch.from_numpy(action))
        _same_magnitudes(tstate.pattern.numpy(), jstate.pattern, f"pattern {k}")
        _close(tts.obs, jts.obs, f"obs {k}", F32, F32)
        _check_info(tts, jts, ("step_energy", "total_energy", "pattern_similarity",
                               "pattern_improvement", "episode_return"), k, F32)
    np.testing.assert_array_equal(np.abs(tstate.pattern[..., 2].numpy()), 1.0)
    np.testing.assert_array_equal(tstate.pattern[..., :2].numpy(), 0.0)


@pytest.mark.parametrize("coupling_update", ["sequential", "simultaneous"])
def test_array_env_signed_zeros_match_jax(coupling_update):
    """The pattern of ``test_array_env_subnormal_pattern_matches_jax``, its
    subnormal transverse parts of either sign, under currents of -2e6, 0 or
    2e6 A/m^2 an array: after every one of 6 steps each component is JAX's
    by magnitude and sign bit. A driven device's transverse parts end at
    +0, as in JAX; an undriven array keeps its subnormals, as XLA's select
    passes them through, where a flush of the whole pattern to +0 loses
    both their magnitude and their sign."""
    tenv, tstate, jstate, step, actions = _subnormal_array(coupling_update, 6,
                                                           (-2e6, 0.0, 2e6))
    kept_negative = 0
    for k, action in enumerate(actions):
        jstate, _ = step(jstate, jnp.asarray(action))
        tstate, _ = tenv.step(tstate, torch.from_numpy(action))
        _same_signs(tstate.pattern.numpy(), jstate.pattern, f"pattern {k}")
        kept_negative += int(np.signbit(np.asarray(jstate.pattern)[..., :2]).sum())
    assert kept_negative > 0  # an undriven array kept negative subnormals


# Atol of each racetrack quantity, in its own units, as the racetrack's
# parity tests hold them.
SCALE = {"positions": 1e-7, "velocities": 1.0, "step_energy": 1e-15, "total_energy": 1e-15,
         "total_displacement": 1e-7, "position_errors": 1e-7, "average_error": 1e-7}


@pytest.mark.parametrize("dtype, width, offset, rtol", [
    # float32: every exp(-dist / r) lies in exp(-103)..exp(-90), subnormal.
    ("float32", 4e-6, 90.0, F32),
    # float64: exp(-722)..exp(-720), subnormal; the file's jitted rtol.
    ("float64", 30e-6, 720.0, 1e-9),
])
def test_racetrack_subnormal_velocities_match_jax(dtype, width, offset, rtol):
    """Two skyrmions a track, ``offset`` radii off the centerline that holds
    the pinning sites, with subnormal velocities; half the tracks undriven,
    the rest under currents and gradients. Thermal off, as the racetrack's
    parity tests run it."""
    n, batch = 2, 8
    kw = dict(dtype=dtype, autoreset=False, include_thermal=False, track_width=width,
              n_skyrmions=n)
    jenv = JSkyrmionEnv(batch_size=batch, config=JSkyrmionConfig(**kw), seed=3)
    tenv = SkyrmionRacetrackEnv(batch_size=batch, config=SkyrmionEnvConfig(**kw), seed=3,
                                device="cpu")
    np.testing.assert_array_equal(tenv.pin_x.numpy(), np.asarray(jenv.pin_x))
    cfg = tenv.config
    r = cfg.skyrmion_radius
    rng = np.random.default_rng(5)
    x = rng.uniform(r, cfg.track_length - r, (batch, n))
    pos = np.stack([x, np.full((batch, n), width / 2 + offset * r)], -1).astype(dtype)
    dist = np.hypot(pos[..., None, 0] - np.asarray(jenv.pin_x), offset * r) / r
    assert 0 < np.exp(-dist.astype(dtype)).max() < np.finfo(dtype).tiny
    vel = _subnormals(rng, (batch, n, 2), np.dtype(dtype))
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(positions=jnp.asarray(pos), velocities=jnp.asarray(vel))
    tstate = convert.skyrmion_state_from_numpy(_state_to_numpy(jstate), device="cpu")
    assert np.all(tstate.velocities.numpy() == vel)

    steps = 6
    j = rng.uniform(-1e12, 1e12, (steps, batch, 2))
    g = rng.uniform(-1e18, 1e18, (steps, batch, 2))
    j[:, :4], g[:, :4] = 0.0, 0.0  # tracks 0-3 undriven: pinning and walls only
    dur = rng.uniform(1e-12, 2e-9, (steps, batch, 1))
    actions = np.concatenate([j, g, dur], -1).astype(dtype)
    step = jax.jit(jenv.step)
    for k, action in enumerate(actions):
        jstate, jts = step(jstate, jnp.asarray(action))
        tstate, tts = tenv.step(tstate, torch.from_numpy(action))
        cols = np.arange(tts.obs.shape[-1]) != 6 * n  # the steps-left entry
        _close(tts.obs[:, cols], np.asarray(jts.obs)[:, cols], f"obs {k}", rtol, rtol)
        _close(tts.obs[:, 6 * n], np.asarray(jts.obs)[:, 6 * n], f"steps left {k}", 2.0**-23,
               0.0)
        _check_info(tts, jts, ("step_energy", "total_energy", "position_errors",
                               "average_error", "total_displacement", "stability_factors",
                               "episode_return"), k, rtol, SCALE)
        for key in ("positions", "velocities"):
            _close(getattr(tstate, key), getattr(jstate, key), f"{key} {k}", rtol,
                   rtol * SCALE[key])
    # The undriven tracks' skyrmions did not move.
    np.testing.assert_array_equal(tstate.positions[:4].numpy(), pos[:4])
