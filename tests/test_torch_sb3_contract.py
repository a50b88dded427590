"""The JAX package's vendored stable-baselines3 contract replay
(``tests/integration/test_sb3_contract.py``) on the port's
``GymSpinTorqueEnv(device="cpu")``, with the JAX file's ``FAST``
configuration unchanged and no sb3 import.

It replays, against the adapter, the call sequences sb3 v2.3.2 makes around
an env during ``model.learn()`` (the JAX file names the sources): the
non-warning assertions of ``check_env``; ``DummyVecEnv``'s loop of seeded
first reset, unseeded reset on ``terminated or truncated`` with the terminal
observation surfaced, and rollout on from the reset observation; float32
Box actions clipped to the bounds and numpy int64 / builtin int / 0-d
Discrete actions; ``set_random_seed``'s reproducible seeded resets; and the
attributes ``Monitor`` reads.

Beside the replay, a seeded rollout is held against the JAX adapter: thermal
off, float64, from the port's reset state handed to both adapters as the
``initial_state`` / ``target_state`` options (the two packages draw resets
from different streams), with the same actions; observations and rewards at
rtol 1e-9 (the vector observation's steps-left entry at float32 rounding),
the tolerance of ``tests/test_torch_env.py``.
"""

import functools

import gymnasium as gym
import numpy as np
import pytest
import torch
from gymnasium import spaces

import spintorque_tpu.envs.gym_adapter as J
import spintorque_tpu_torch.envs.gym_adapter as T

torch.set_num_threads(1)

FAST = dict(
    include_thermal_fluctuations=False,
    max_duration=2e-10,
    max_steps=8,
)

GymSpinTorqueEnv = functools.partial(T.GymSpinTorqueEnv, device="cpu")


@pytest.fixture(params=["continuous", "discrete"])
def env(request):
    e = GymSpinTorqueEnv(action_mode=request.param, **FAST)
    yield e
    e.close()


def _policy_action(env, rng):
    """An action the way sb3 produces one (not via space.sample())."""
    if isinstance(env.action_space, spaces.Box):
        # on_policy_algorithm.py: float32 network output clipped to bounds.
        raw = rng.standard_normal(env.action_space.shape).astype(np.float32) * 10
        return np.clip(raw, env.action_space.low, env.action_space.high)
    # DummyVecEnv passes the element of an int64 actions array.
    return np.int64(rng.integers(0, env.action_space.n))


def test_env_checker_core_assertions(env):
    """The non-warning assertions of sb3's check_env, replayed verbatim."""
    assert isinstance(env, gym.Env)
    assert isinstance(env.action_space, spaces.Space)
    assert isinstance(env.observation_space, spaces.Space)

    if isinstance(env.action_space, spaces.Box):
        assert env.action_space.low.shape == env.action_space.shape
        assert env.action_space.high.shape == env.action_space.shape
        assert np.all(env.action_space.low <= env.action_space.high)
        # Non-normalized bounds only trigger a check_env WARNING (the
        # adapter keeps the reference's physical-units Box for parity,
        # spin_torque_env.py action space); the hard assertion is that the
        # bounds are finite so sb3's clipping is well-defined.
        assert np.isfinite(env.action_space.low).all()
        assert np.isfinite(env.action_space.high).all()

    out = env.reset(seed=0)
    assert isinstance(out, tuple) and len(out) == 2
    obs, info = out
    assert isinstance(info, dict)
    assert env.observation_space.contains(obs), obs
    assert obs.dtype == env.observation_space.dtype

    action = env.action_space.sample()
    out = env.step(action)
    assert isinstance(out, tuple) and len(out) == 5
    obs, reward, terminated, truncated, info = out
    assert env.observation_space.contains(obs)
    assert isinstance(float(reward), float)
    assert isinstance(bool(terminated), bool) and isinstance(
        terminated, (bool, np.bool_))
    assert isinstance(truncated, (bool, np.bool_))
    assert isinstance(info, dict)


def test_dummy_vec_env_rollout_replay(env):
    """DummyVecEnv's step_wait loop: unseeded reset on done, terminal obs
    surfaced, rollout continues — 3 episodes worth of steps."""
    rng = np.random.default_rng(0)
    env.action_space.seed(0)  # set_random_seed path
    obs, _ = env.reset(seed=42)
    episodes = 0
    for _ in range(40):
        action = _policy_action(env, rng)
        obs, reward, terminated, truncated, info = env.step(action)
        assert np.isfinite(float(reward))
        if terminated or truncated:
            terminal_obs = obs  # DummyVecEnv: infos[i]["terminal_observation"]
            assert env.observation_space.contains(terminal_obs)
            obs, reset_info = env.reset()  # no seed — must not raise
            assert isinstance(reset_info, dict)
            episodes += 1
            if episodes == 3:
                break
        assert env.observation_space.contains(obs)
    assert episodes == 3, "max_steps=8 must truncate within the budget"


def test_discrete_accepts_int64_and_builtin_int():
    """DQN's buffer round-trips actions through numpy; both int flavors
    (and 0-d arrays, which ``int()`` conversion produces) must step."""
    e = GymSpinTorqueEnv(action_mode="discrete", **FAST)
    try:
        e.reset(seed=3)
        for a in (np.int64(1), int(2), np.array(3)):
            obs, reward, *_ = e.step(a)
            assert np.isfinite(float(reward))
    finally:
        e.close()


def test_seeded_reset_reproducible_like_set_random_seed():
    """sb3's seeding contract: two envs seeded identically produce the
    same rollout under the same actions."""
    rng = np.random.default_rng(1)
    acts = [np.float32(rng.uniform(-1, 1, size=(3,))) for _ in range(5)]

    def rollout():
        e = GymSpinTorqueEnv(action_mode="continuous", **FAST)
        try:
            obs0, _ = e.reset(seed=7)
            trace = [obs0]
            for a in acts:
                obs, r, te, tr, _ = e.step(a)
                trace.append(obs)
                if te or tr:
                    break
            return np.stack(trace)
        finally:
            e.close()

    np.testing.assert_array_equal(rollout(), rollout())


def test_monitor_wrapper_surface():
    """sb3 always wraps with Monitor: it reads render_mode, metadata, spec
    and forwards reset kwargs; the attributes must exist with the expected
    types (monitor.py v2.3.2)."""
    e = GymSpinTorqueEnv(action_mode="continuous", **FAST)
    try:
        assert hasattr(e, "render_mode")
        assert isinstance(e.metadata, dict) and "render_modes" in e.metadata
        assert hasattr(e, "spec")  # gym.Env attribute, None when unregistered
        # gym.Wrapper must be able to wrap it (Monitor subclasses Wrapper).
        wrapped = gym.Wrapper(e)
        obs, info = wrapped.reset(seed=11)
        assert e.observation_space.contains(obs)
    finally:
        e.close()


def test_seeded_rollout_matches_jax():
    """The seeded rollout of the test above, in float64, against the JAX
    adapter from the same state."""
    kw = dict(FAST, dtype="float64", action_mode="continuous")
    rng = np.random.default_rng(1)
    acts = [rng.uniform(-1, 1, size=(3,)) for _ in range(5)]
    port = GymSpinTorqueEnv(**kw)
    port.reset(seed=7)
    state = port._state
    options = {"initial_state": state.m[0].numpy(), "target_state": state.target[0].numpy()}
    ref = J.GymSpinTorqueEnv(**kw)
    steps_left = 8  # the vector observation's float32 entry
    cols = np.arange(port.observation_space.shape[0]) != steps_left
    got, want = port.reset(seed=7, options=options)[0], ref.reset(seed=7, options=options)[0]
    np.testing.assert_allclose(got[cols], want[cols], rtol=1e-9, atol=1e-12)
    for a in acts:
        got, want = port.step(a), ref.step(a)
        np.testing.assert_allclose(got[0][cols], want[0][cols], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got[0][steps_left], want[0][steps_left], rtol=2.0**-23)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-9, atol=1e-12)
        assert got[2:4] == want[2:4]
        if got[2] or got[3]:
            break
