"""The port's SpinTorqueArrayEnv against the JAX package's.

Both envs run float64 from the same state: the JAX env resets, its state
leaves go to numpy, and ``convert.array_state_from_numpy`` carries them
into the port. The same actions (seeded numpy) then drive both for a
10-step episode, in every action mode x observation mode x coupling update,
on a 3 x 4 array (rows and columns differ, so a transposed index shows).
Against JAX run op by op (``jax.disable_jit``: the first step of every
combination, and whole episodes in both coupling modes) obs, reward, flags,
energy and pattern agree at rtol 1e-12; against the jitted JAX step, which
XLA compiles with fused multiply-adds, at rtol 1e-9. The values that cancel
to near zero (the similarity improvement, the std of unit norms inside the
reward) get atol 1e-12 and 1e-9 beside them.

The steps-remaining entry of the vector observation is float32 in JAX
((max_steps - step) / max_steps divides int32 by int); the jitted step
rounds it through the reciprocal of max_steps, so against it that entry is
held at float32 rounding, rtol 2^-23.

The behaviours of ``tests/unit/test_array_env.py`` are checked on the
port: the sequential mode's order dependence, the simultaneous mode's
permutation equivariance, the zero-current no-op and success on the
target; and ``step`` leaves the state it was given unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.envs.array import ArrayEnvConfig as JConfig
from spintorque_tpu.envs.array import SpinTorqueArrayEnv as JEnv
from spintorque_tpu.envs.array import checkerboard_pattern as j_checkerboard
from spintorque_tpu.envs.array import coupling_matrix as j_coupling
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import (
    ArrayEnvConfig,
    SpinTorqueArrayEnv,
    checkerboard_pattern,
    coupling_matrix,
)

torch.set_num_threads(1)

B = 4
ROWS, COLS = 3, 4
N = ROWS * COLS
STEPS = 10
ACTION_MODES = ("individual", "row", "column", "global")
OBS_MODES = ("array", "vector", "dict")
COUPLING = ("sequential", "simultaneous")


def _jax_state_to_numpy(js):
    leaves = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    stats = leaves.pop("reward_stats")
    d = jax.tree.map(np.asarray, leaves)
    d["reward_stats"] = {
        name: jax.tree.map(np.asarray,
                           {f.name: getattr(st, f.name) for f in dataclasses.fields(st)})
        for name, st in stats.items()
    }
    return d


def _config_kw(**kw):
    base = dict(rows=ROWS, cols=COLS, dtype="float64", autoreset=False)
    base.update(kw)
    return base


def _pair(seed=0, batch=B, device_params=None, **kw):
    jenv = JEnv(batch_size=batch, device_params=device_params, config=JConfig(**_config_kw(**kw)))
    tenv = SpinTorqueArrayEnv(batch_size=batch, device_params=device_params,
                              config=ArrayEnvConfig(**_config_kw(**kw)), device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(seed))
    tstate = convert.array_state_from_numpy(_jax_state_to_numpy(jstate), device="cpu")
    return jenv, jstate, tenv, tstate


def _actions(mode, steps, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    current = rng.uniform(-2e6, 2e6, (steps, batch))
    current[rng.random((steps, batch)) < 0.2] = 0.0  # zero-current devices stay put
    if mode == "global":
        return np.stack([rng.uniform(0, 5e-9, (steps, batch)), current], -1)
    hi = {"individual": N, "row": ROWS, "column": COLS}[mode]
    index = rng.integers(-1, hi + 1, (steps, batch)).astype(float)  # out of range clips
    duration = rng.uniform(1e-12, 5e-9, (steps, batch))
    duration[0, 0] = 1.0  # clipped to max_duration
    return np.stack([index, current, duration], -1)


def _close(got, ref, name, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (name, got.shape, ref.shape,
                                                               got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def _check_step(tts, jts, tstate, jstate, mode, rtol, k):
    atol = rtol  # improvement and the unit-norm std cancel to ~0
    if isinstance(jts.obs, dict):
        assert set(tts.obs) == set(jts.obs)
        for key in jts.obs:
            _close(tts.obs[key], jts.obs[key], f"obs[{key}] step {k}", rtol, atol)
    elif mode == "vector" and rtol > 1e-12:
        steps_left = 2 * N * 3 + 1
        cols = np.arange(tts.obs.shape[-1]) != steps_left
        _close(tts.obs[:, cols], np.asarray(jts.obs)[:, cols], f"obs step {k}", rtol, atol)
        _close(tts.obs[:, steps_left], np.asarray(jts.obs)[:, steps_left],
               f"steps left step {k}", 2.0**-23)
    else:
        _close(tts.obs, jts.obs, f"obs step {k}", rtol, atol)
    _close(tts.reward, jts.reward, f"reward step {k}", rtol, atol)
    np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
    np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
    for key in ("step_energy", "total_energy", "pattern_similarity", "episode_return"):
        _close(tts.info[key], jts.info[key], f"info[{key}] step {k}", rtol, atol)
    _close(tts.info["pattern_improvement"], jts.info["pattern_improvement"],
           f"improvement step {k}", rtol, atol)
    for name in jts.info["reward_components"]:
        _close(tts.info["reward_components"][name], jts.info["reward_components"][name],
               f"reward component {name} step {k}", rtol, atol)
    _close(tstate.pattern, jstate.pattern, f"pattern step {k}", rtol, atol)
    _close(tstate.step, jstate.step, f"step count {k}", 0.0)


def _run(jenv, jstate, tenv, tstate, actions, observation_mode, jit):
    rtol = 1e-9 if jit else 1e-12
    for k, action in enumerate(actions):
        if jit:
            jstate, jts = jenv.step(jstate, jnp.asarray(action))
        else:
            with jax.disable_jit():
                jstate, jts = jenv.step(jstate, jnp.asarray(action))
        tstate, tts = tenv.step(tstate, torch.tensor(action))
        _check_step(tts, jts, tstate, jstate, observation_mode, rtol, k)


@pytest.mark.parametrize("coupling_update", COUPLING)
@pytest.mark.parametrize("observation_mode", OBS_MODES)
@pytest.mark.parametrize("action_mode", ACTION_MODES)
def test_step_and_episode_match_jax(action_mode, observation_mode, coupling_update):
    """One step against JAX op by op, then a 10-step episode against the
    jitted JAX step, from the same state and actions."""
    kw = dict(action_mode=action_mode, observation_mode=observation_mode,
              coupling_update=coupling_update)
    jenv, jstate, tenv, tstate = _pair(seed=ACTION_MODES.index(action_mode), **kw)
    actions = _actions(action_mode, STEPS, seed=OBS_MODES.index(observation_mode))
    _run(jenv, jstate, tenv, tstate, actions[:1], observation_mode, jit=False)
    _run(jenv, jstate, tenv, tstate, actions, observation_mode, jit=True)


@pytest.mark.parametrize("coupling_update", COUPLING)
def test_episode_matches_jax_op_by_op(coupling_update):
    """A whole 10-step episode against JAX op by op (the costly side: the
    sequential mode runs ~1,000 eager JAX ops a step)."""
    jenv, jstate, tenv, tstate = _pair(seed=9, observation_mode="vector",
                                       coupling_update=coupling_update)
    _run(jenv, jstate, tenv, tstate, _actions("individual", STEPS, seed=9), "vector", jit=False)


def test_uniformity_uses_the_population_std():
    """Unit norms give a std of ~1e-16 either way; from a pattern of mixed
    norms, left in place by a zero-current step, the reward's uniformity
    term shows which std it takes (JAX's is the population std)."""
    jenv, jstate, tenv, _ = _pair(seed=2, action_mode="global")
    scale = np.random.default_rng(3).uniform(0.5, 1.5, (B, N, 1))
    jstate = jstate.replace(pattern=jstate.pattern * scale)
    tstate = convert.array_state_from_numpy(_jax_state_to_numpy(jstate), device="cpu")
    _run(jenv, jstate, tenv, tstate, np.zeros((1, B, 2)), "array", jit=False)


def test_coupling_and_checkerboard_match_jax():
    for kw in (dict(rows=3, cols=3), dict(rows=4, cols=5, coupling_type="exchange"),
               dict(rows=2, cols=6, coupling_type="stray_field", coupling_strength=0.7),
               dict(include_coupling=False)):
        np.testing.assert_array_equal(coupling_matrix(ArrayEnvConfig(**kw)),
                                      j_coupling(JConfig(**kw)))
    for r, c in ((4, 4), (3, 5), (1, 2)):
        np.testing.assert_array_equal(checkerboard_pattern(r, c), j_checkerboard(r, c))
    C = coupling_matrix(ArrayEnvConfig(rows=3, cols=3))
    np.testing.assert_allclose(C[0, 4], 0.1 / np.sqrt(2) ** 3)


def test_reset_and_observation_shapes():
    for mode, shape in (("array", (3, ROWS, COLS, 6)), ("vector", (3, N * 6 + 4))):
        env = SpinTorqueArrayEnv(batch_size=3, config=ArrayEnvConfig(**_config_kw(
            observation_mode=mode)), device="cpu")
        state, obs = env.reset(seed=0)
        assert state.pattern.shape == (3, N, 3) and obs.shape == shape
        np.testing.assert_allclose(torch.linalg.vector_norm(state.pattern, dim=-1).numpy(), 1.0,
                                   rtol=1e-12)
    env = SpinTorqueArrayEnv(batch_size=3, config=ArrayEnvConfig(**_config_kw(
        observation_mode="dict")), device="cpu")
    _, obs = env.reset(seed=0)
    assert set(obs) == {"current_pattern", "target_pattern", "pattern_similarity",
                        "steps_remaining", "total_energy"}
    assert obs["steps_remaining"].dtype == torch.int32
    with pytest.raises(ValueError, match="coupling_update"):
        SpinTorqueArrayEnv(config=ArrayEnvConfig(coupling_update="bogus"), device="cpu")
    with pytest.raises(ValueError, match="Target pattern shape"):
        SpinTorqueArrayEnv(target_pattern=np.zeros((2, 2, 3)), device="cpu")


@pytest.mark.parametrize("coupling_update", COUPLING)
def test_step_leaves_the_given_state_unchanged(coupling_update):
    env = SpinTorqueArrayEnv(batch_size=B, config=ArrayEnvConfig(
        **_config_kw(coupling_update=coupling_update, autoreset=True)), device="cpu")
    state, _ = env.reset(seed=3)
    before = {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
              if isinstance(getattr(state, f.name), torch.Tensor)}
    new, ts = env.step(state, torch.tensor([[5.0, 1e6, 1e-9]] * B, dtype=torch.float64))
    assert not torch.equal(new.pattern, state.pattern)
    for name, value in before.items():
        assert torch.equal(getattr(state, name), value), name
    assert ts.info["final_observation"].data_ptr() != ts.obs.data_ptr()


def test_zero_current_is_noop_and_individual_moves_one_device():
    env = SpinTorqueArrayEnv(batch_size=2, config=ArrayEnvConfig(
        **_config_kw(action_mode="global")), device="cpu")
    state, _ = env.reset(seed=4)
    new, ts = env.step(state, torch.zeros((2, 2), dtype=torch.float64))
    assert torch.equal(new.pattern, state.pattern)
    assert torch.all(ts.info["step_energy"] == 0)
    env = SpinTorqueArrayEnv(batch_size=2, config=ArrayEnvConfig(
        **_config_kw(include_coupling=False)), device="cpu")
    state, _ = env.reset(seed=1)
    new, ts = env.step(state, torch.tensor([[5.0, 1e6, 1e-9]] * 2, dtype=torch.float64))
    changed = ((new.pattern - state.pattern).abs() > 1e-12).any(-1)
    assert changed[:, 5].all() and changed.sum() == 2
    assert torch.all(ts.info["step_energy"] > 0)


def test_success_on_target_pattern():
    env = SpinTorqueArrayEnv(batch_size=2, config=ArrayEnvConfig(**_config_kw()), device="cpu")
    state, _ = env.reset(seed=5)
    state = dataclasses.replace(state, pattern=state.target.clone())
    _, ts = env.step(state, torch.tensor([[0.0, 0.0, 1e-9]] * 2, dtype=torch.float64))
    assert ts.terminated.all()
    # pattern_match 10 * 10 + uniformity 2 * 1 (energy and progress 0).
    np.testing.assert_allclose(ts.reward.numpy(), 102.0, atol=1e-9)


# The JAX test's tame device: at the stock K_u the 1 ns 'global' pulse has
# gamma H dt >> 1, and the renormalized Euler is too sensitive to compare
# the two coupling semantics.
_TAME = {"uniaxial_anisotropy": 1.0}


def _tame(mode, coupling_strength, batch):
    return SpinTorqueArrayEnv(
        batch_size=batch, device_params=dict(_TAME), device="cpu",
        config=ArrayEnvConfig(dtype="float64", autoreset=False, action_mode="global",
                              coupling_update=mode, coupling_strength=coupling_strength),
    )


def test_sequential_order_dependence_and_simultaneous_equivariance():
    perm = np.random.default_rng(7).permutation(16)
    action = torch.tensor([[0.0, 1e6]] * 2, dtype=torch.float64)

    def run(mode):
        env_a, env_b = _tame(mode, 2000.0, 2), _tame(mode, 2000.0, 2)
        env_b.coupling = env_a.coupling[perm][:, perm]
        state, _ = env_a.reset(seed=3)
        state_b = dataclasses.replace(state, pattern=state.pattern[:, perm, :],
                                      target=state.target[:, perm, :])
        s_a, _ = env_a.step(state, action)
        s_b, _ = env_b.step(state_b, action)
        return s_a.pattern[:, perm, :].numpy(), s_b.pattern.numpy()

    out_perm, out_b = run("simultaneous")
    np.testing.assert_allclose(out_b, out_perm, atol=1e-9)
    out_perm, out_b = run("sequential")
    assert np.abs(out_b - out_perm).max() > 1e-3  # the order dependence is real


def test_modes_agree_at_weak_coupling():
    env_seq, env_sim = _tame("sequential", 1e-4, 3), _tame("simultaneous", 1e-4, 3)
    state, _ = env_seq.reset(seed=2)
    action = torch.tensor([[0.0, 1e6]] * 3, dtype=torch.float64)
    s_seq, ts_seq = env_seq.step(state, action)
    s_sim, ts_sim = env_sim.step(state, action)
    np.testing.assert_allclose(ts_sim.info["step_energy"].numpy(),
                               ts_seq.info["step_energy"].numpy(), rtol=1e-12)
    assert (s_seq.pattern - state.pattern).abs().max() > 1e-5
    np.testing.assert_allclose(s_sim.pattern.numpy(), s_seq.pattern.numpy(), atol=1e-6)


def test_autoreset_resets_done_arrays():
    env = SpinTorqueArrayEnv(batch_size=B, config=ArrayEnvConfig(
        **_config_kw(autoreset=True, max_steps=2, observation_mode="dict")), device="cpu")
    state, _ = env.reset(seed=6)
    action = torch.tensor([[1.0, 1e6, 1e-9]] * B, dtype=torch.float64)
    state, ts = env.step(state, action)
    assert not ts.truncated.any() and torch.equal(state.step, torch.ones(B, dtype=torch.int32))
    stepped = state.pattern
    state, ts = env.step(state, action)
    assert ts.truncated.all()
    assert torch.equal(state.step, torch.zeros(B, dtype=torch.int32))
    assert torch.all(state.total_energy == 0) and torch.all(state.episode_return == 0)
    assert not torch.allclose(state.pattern, stepped)
    np.testing.assert_allclose(torch.linalg.vector_norm(state.pattern, dim=-1).numpy(), 1.0,
                               rtol=1e-12)
    assert torch.equal(ts.obs["current_pattern"], state.pattern.reshape(B, ROWS, COLS, 3))
    assert torch.all(ts.info["final_observation"]["steps_remaining"] == 0)


def test_simultaneous_scales_to_large_arrays():
    env = SpinTorqueArrayEnv(batch_size=2, device="cpu", config=ArrayEnvConfig(
        rows=16, cols=16, coupling_update="simultaneous", action_mode="global",
        autoreset=False))
    state, _ = env.reset(seed=4)
    state, _ = env.step(state, torch.tensor([[0.0, 1e6]] * 2))
    assert state.pattern.shape == (2, 256, 3) and state.pattern.dtype == torch.float32
    assert torch.isfinite(state.pattern).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(state.pattern, dim=-1).numpy(), 1.0,
                               rtol=1e-5)
