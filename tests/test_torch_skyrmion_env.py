"""The port's SkyrmionRacetrackEnv against the JAX package's.

Thermal off, both envs run float64 from the same state (the JAX state's
leaves carried across by ``convert.skyrmion_state_from_numpy``) and the
same seeded actions: 12-step episodes in continuous and discrete mode,
vector and dict observations, pinning on, agree with JAX op by op
(``jax.disable_jit``) at rtol 1e-12 and with the jitted JAX step at rtol
1e-9; values that cancel to near zero (velocities, displacements, the
reward's improvement terms) get the same atol in units of their scale.
The pinning sites are the same bits: both packages draw them with the
same numpy calls from the construction seed.

Thermal on, the kick comes from another random stream, so it is held in
distribution: the first step's kick direction, read from the velocity
with every other force off, is uniform on the circle (Kolmogorov-Smirnov),
and its magnitude, read from |v|, equals the JAX env's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from spintorque_tpu.envs.skyrmion import SkyrmionEnvConfig as JConfig
from spintorque_tpu.envs.skyrmion import SkyrmionRacetrackEnv as JEnv
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import SkyrmionEnvConfig, SkyrmionRacetrackEnv

torch.set_num_threads(1)

B = 8
STEPS = 12
# Atol of each compared quantity, in its own units (positions ~1e-7 m,
# velocities ~1 m/s, energies ~1e-15 J, rewards ~1-100).
SCALE = {"positions": 1e-7, "velocities": 1.0, "step_energy": 1e-15, "total_energy": 1e-15,
         "total_displacement": 1e-7, "position_errors": 1e-7, "average_error": 1e-7}


def _jax_state_to_numpy(js):
    leaves = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    stats_ = leaves.pop("reward_stats")
    d = jax.tree.map(np.asarray, leaves)
    d["reward_stats"] = {
        name: jax.tree.map(np.asarray,
                           {f.name: getattr(st, f.name) for f in dataclasses.fields(st)})
        for name, st in stats_.items()
    }
    return d


def _configs(**kw):
    base = dict(dtype="float64", autoreset=False, include_thermal=False)
    base.update(kw)
    return JConfig(**base), SkyrmionEnvConfig(**base)


def _pair(seed=0, batch=B, env_seed=3, **kw):
    jcfg, tcfg = _configs(**kw)
    jenv = JEnv(batch_size=batch, config=jcfg, seed=env_seed)
    tenv = SkyrmionRacetrackEnv(batch_size=batch, config=tcfg, seed=env_seed, device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(seed))
    tstate = convert.skyrmion_state_from_numpy(_jax_state_to_numpy(jstate), device="cpu")
    return jenv, jstate, tenv, tstate


def _actions(mode, steps, seed, batch=B):
    rng = np.random.default_rng(seed)
    if mode == "discrete":
        a = rng.integers(0, 45, (steps, batch))
        a[0, :3] = [-4, 50, 44]  # out of range clips
        return a
    jx = rng.uniform(-1e12, 1e12, (steps, batch))
    jy = rng.uniform(-1e12, 1e12, (steps, batch))
    jx[rng.random((steps, batch)) < 0.2] = 0.0
    jy[:, 0] = 0.0
    jx[:, 0] = 0.0  # env 0 never driven: pinning and walls only
    g = rng.uniform(-1e18, 1e18, (steps, batch, 2))
    dur = rng.uniform(1e-12, 2e-9, (steps, batch))
    a = np.concatenate([jx[..., None], jy[..., None], g, dur[..., None]], -1)
    a[0, 1] = [3e12, -3e12, 5e18, 0.0, 1.0]  # clipped
    return a


def _close(got, ref, name, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def _run(jenv, jstate, tenv, tstate, actions, jit):
    rtol = 1e-9 if jit else 1e-12
    for k, action in enumerate(actions):
        if jit:
            jstate, jts = jenv.step(jstate, jnp.asarray(action))
        else:
            with jax.disable_jit():
                jstate, jts = jenv.step(jstate, jnp.asarray(action))
        tstate, tts = tenv.step(tstate, torch.tensor(action))
        if isinstance(jts.obs, dict):
            for key in jts.obs:
                _close(tts.obs[key], jts.obs[key], f"obs[{key}] {k}", rtol,
                       rtol * SCALE.get(key, 1.0))
        else:
            # The steps-left entry is float32 in JAX, rounded through the
            # reciprocal of max_steps when jitted.
            n = tenv.config.n_skyrmions
            left = 6 * n
            cols = np.arange(tts.obs.shape[-1]) != left
            _close(tts.obs[:, cols], np.asarray(jts.obs)[:, cols], f"obs {k}", rtol, rtol)
            _close(tts.obs[:, left], np.asarray(jts.obs)[:, left], f"steps left {k}",
                   2.0**-23 if jit else 0.0)
        _close(tts.reward, jts.reward, f"reward {k}", rtol, rtol)
        np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
        np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
        for key in ("step_energy", "total_energy", "position_errors", "average_error",
                    "total_displacement", "stability_factors", "episode_return"):
            _close(tts.info[key], jts.info[key], f"info[{key}] {k}", rtol,
                   rtol * SCALE.get(key, 1.0))
        for name in jts.info["reward_components"]:
            _close(tts.info["reward_components"][name], jts.info["reward_components"][name],
                   f"reward component {name} {k}", rtol, rtol)
        for key in ("positions", "velocities"):
            _close(getattr(tstate, key), getattr(jstate, key), f"{key} {k}", rtol,
                   rtol * SCALE[key])


@pytest.mark.parametrize("observation_mode", ["vector", "dict"])
@pytest.mark.parametrize("action_mode", ["continuous", "discrete"])
def test_episode_matches_jax(action_mode, observation_mode):
    """Thermal off, pinning on, three skyrmions: an episode against JAX op by
    op, then the same against the jitted step."""
    kw = dict(action_mode=action_mode, observation_mode=observation_mode, n_skyrmions=3)
    actions = _actions(action_mode, STEPS, seed=len(observation_mode))
    for jit in (False, True):
        jenv, jstate, tenv, tstate = _pair(seed=1, **kw)
        _run(jenv, jstate, tenv, tstate, actions, jit)


def test_pin_sites_equal_bit_for_bit():
    for kw, seed in ((dict(), 0), (dict(skyrmion_radius=5e-9), 11),
                     (dict(track_length=100e-9), 2), (dict(include_pinning=False), 0)):
        jcfg, tcfg = _configs(**kw)
        jenv = JEnv(config=jcfg, seed=seed)
        tenv = SkyrmionRacetrackEnv(config=tcfg, seed=seed, device="cpu")
        np.testing.assert_array_equal(tenv.pin_x.numpy(), np.asarray(jenv.pin_x))
        np.testing.assert_array_equal(tenv.pin_strength.numpy(), np.asarray(jenv.pin_strength))
    assert SkyrmionRacetrackEnv(device="cpu").pin_x.shape == (2,)


def test_thermal_kick_uniform_direction_and_jax_magnitude():
    """One thermal step with no current, gradient or pinning: the velocity
    is along the kick, and its size depends on the kick's magnitude only."""
    batch = 4096
    kw = dict(include_thermal=True, include_pinning=False, dtype="float64")
    jenv = JEnv(batch_size=batch, config=JConfig(**kw, autoreset=False))
    tenv = SkyrmionRacetrackEnv(batch_size=batch, config=SkyrmionEnvConfig(**kw, autoreset=False),
                                device="cpu")
    action = np.zeros((batch, 5))
    action[:, 4] = 1e-9
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate, _ = jenv.step(jstate, jnp.asarray(action))
    tstate, _ = tenv.reset(seed=0)
    tstate, _ = tenv.step(tstate, torch.tensor(action))
    v = tstate.velocities[:, 0].numpy()
    speed = np.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(speed, np.linalg.norm(np.asarray(jstate.velocities)[:, 0], axis=-1),
                               rtol=1e-12)
    np.testing.assert_allclose(speed, speed[0], rtol=1e-12)  # one magnitude for every kick
    angle = np.arctan2(v[:, 1], v[:, 0])
    assert stats.kstest(angle, stats.uniform(-np.pi, 2 * np.pi).cdf).pvalue > 1e-3
    assert stats.kstest(np.asarray(jnp.arctan2(jstate.velocities[:, 0, 1],
                                               jstate.velocities[:, 0, 0])),
                        stats.uniform(-np.pi, 2 * np.pi).cdf).pvalue > 1e-3


def test_determinism_under_one_seed():
    tenv = SkyrmionRacetrackEnv(batch_size=4, device="cpu", config=SkyrmionEnvConfig(
        n_skyrmions=2, dtype="float64", autoreset=True, max_steps=3))
    a = torch.tensor([[1e11, 0.0, 1e17, 0.0, 1e-9]] * 4, dtype=torch.float64)
    runs = []
    for _ in range(2):
        state, obs = tenv.reset(seed=9)
        out = [obs]
        for _ in range(5):  # through one auto-reset
            state, ts = tenv.step(state, a)
            out += [ts.obs, ts.reward, state.positions]
        runs.append(out)
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    state, _ = tenv.reset(seed=10)
    assert not torch.equal(state.positions, tenv.reset(seed=9)[0].positions)


def test_walls_hold_and_success_at_targets():
    tenv = SkyrmionRacetrackEnv(batch_size=2, device="cpu", config=SkyrmionEnvConfig(
        dtype="float64", autoreset=False, include_thermal=False, include_pinning=False))
    cfg = tenv.config
    state, _ = tenv.reset(seed=2)
    a = torch.tensor([[cfg.max_current, 0.0, 0.0, 0.0, 2e-9]] * 2, dtype=torch.float64)
    for _ in range(20):
        state, _ = tenv.step(state, a)
    x, y = state.positions[..., 0], state.positions[..., 1]
    r = cfg.skyrmion_radius
    assert ((x >= r) & (x <= cfg.track_length - r) & (y >= r) & (y <= cfg.track_width - r)).all()
    target = torch.stack([tenv.target_x, torch.full_like(tenv.target_x, cfg.track_width / 2)], -1)
    state = dataclasses.replace(state, positions=target.expand(2, 1, 2).clone(),
                                velocities=torch.zeros_like(state.velocities))
    _, ts = tenv.step(state, torch.zeros((2, 5), dtype=torch.float64))
    assert ts.terminated.all()
    # positioning 10 * 10 + stability 5 * 1 (every velocity zero).
    np.testing.assert_allclose(ts.reward.numpy(), 105.0, atol=1e-9)


def test_set_targets_and_discrete_table():
    tenv = SkyrmionRacetrackEnv(batch_size=3, device="cpu", config=SkyrmionEnvConfig(
        dtype="float64", n_skyrmions=2, action_mode="discrete", observation_mode="dict"))
    assert tenv.num_actions == 45
    tenv.set_targets([100e-9, 900e-9])
    state, obs = tenv.reset(seed=0)
    np.testing.assert_array_equal(obs["target_positions"].numpy(), [[100e-9, 900e-9]] * 3)
    jx, jy, gx, gy, dur = tenv._decode_action(torch.tensor([0, 9, 44]))
    np.testing.assert_array_equal(jx.numpy(), [5e11, -5e11, 0.0])
    np.testing.assert_array_equal(gx.numpy(), [0.0, 0.0, 1e18])
    np.testing.assert_array_equal(dur.numpy(), [0.1e-9, 0.1e-9, 1e-9])
    with pytest.raises(ValueError, match="target positions"):
        SkyrmionRacetrackEnv(target_positions=[1e-7], config=SkyrmionEnvConfig(n_skyrmions=2),
                             device="cpu")
