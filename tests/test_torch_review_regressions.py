"""Two of the JAX package's code-review regressions
(``tests/unit/test_review_regressions.py``) on the port, on the CPU: a
string ``normalize`` mode in the reward of the array env (``running_std``)
and of the skyrmion racetrack (``running_mean``), and the racetrack
adapter's per-reset target override.

Both envs are deterministic here (the array env has no thermal term; the
racetrack runs without thermal kicks or pinning), so each is also held
against the JAX env from the JAX env's reset state (carried across by
``spintorque_tpu_torch.convert``) with the same actions: rewards and the
running statistics at rtol 1e-9, the jitted JAX step's tolerance in
``tests/test_torch_array_env.py`` and ``tests/test_torch_skyrmion_env.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import spintorque_tpu.envs.gym_adapter as J
import spintorque_tpu_torch.envs.gym_adapter as T
from spintorque_tpu.envs import ArrayEnvConfig as JArrayConfig
from spintorque_tpu.envs import SkyrmionEnvConfig as JSkyrmionConfig
from spintorque_tpu.envs import SkyrmionRacetrackEnv as JSkyrmionEnv
from spintorque_tpu.envs import SpinTorqueArrayEnv as JArrayEnv
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import (
    ArrayEnvConfig,
    SkyrmionEnvConfig,
    SkyrmionRacetrackEnv,
    SpinTorqueArrayEnv,
)

torch.set_num_threads(1)

RTOL = 1e-9


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


def _stats_close(got, want):
    assert set(got) == set(want)
    for name, st in want.items():
        for f in dataclasses.fields(st):
            np.testing.assert_allclose(np.asarray(getattr(got[name], f.name)),
                                       np.asarray(getattr(st, f.name)), rtol=RTOL,
                                       err_msg=f"{name}.{f.name}")


def test_array_env_running_normalized_reward():
    """Finding: string normalize modes crashed the array/skyrmion envs."""
    reward = {"energy": {"weight": 1.0, "function": "energy", "normalize": "running_std"}}
    cfg = dict(dtype="float64", autoreset=False, action_mode="global")
    env = SpinTorqueArrayEnv(batch_size=2, reward_components=reward,
                             config=ArrayEnvConfig(**cfg), device="cpu")
    jenv = JArrayEnv(batch_size=2, reward_components=reward, config=JArrayConfig(**cfg))
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    state = convert.array_state_from_numpy(_jax_state_to_numpy(jstate), device="cpu")
    for _ in range(3):
        state, ts = env.step(state, torch.tensor([[0.0, 1e5]] * 2, dtype=torch.float64))
        jstate, jts = jenv.step(jstate, jnp.asarray([[0.0, 1e5]] * 2, jnp.float64))
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), rtol=RTOL)
    assert np.isfinite(ts.reward.numpy()).all()
    assert "energy" in state.reward_stats
    _stats_close(state.reward_stats, jstate.reward_stats)


def _stability(ctx):
    return ctx.extras["stability_factors"].mean(-1)


def test_skyrmion_env_running_normalized_reward_and_target_override():
    reward = {"stability": {"weight": 1.0, "function": _stability,
                            "normalize": "running_mean"}}
    cfg = dict(dtype="float64", autoreset=False, include_thermal=False, include_pinning=False)
    env = SkyrmionRacetrackEnv(batch_size=2, reward_components=reward,
                               config=SkyrmionEnvConfig(**cfg), device="cpu")
    jenv = JSkyrmionEnv(batch_size=2, reward_components=reward, config=JSkyrmionConfig(**cfg))
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    state = convert.skyrmion_state_from_numpy(_jax_state_to_numpy(jstate), device="cpu")
    state, ts = env.step(state, torch.zeros((2, 5), dtype=torch.float64))
    jstate, jts = jenv.step(jstate, jnp.zeros((2, 5), jnp.float64))
    assert np.isfinite(ts.reward.numpy()).all()
    np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), rtol=RTOL)
    _stats_close(state.reward_stats, jstate.reward_stats)

    # Finding: target override was a stale jit constant.
    kw = dict(include_thermal_fluctuations=False, include_pinning=False)
    g, jg = T.GymSkyrmionRacetrackEnv(device="cpu", **kw), J.GymSkyrmionRacetrackEnv(**kw)
    first = {"initial_positions": np.array([[500e-9, 100e-9]]), "target_positions": [500e-9]}
    g.reset(seed=0, options=first)
    jg.reset(seed=0, options=first)
    # At the target -> success immediately.
    obs, r, te, tr, info = g.step(np.zeros(5, np.float32))
    assert te
    assert te == jg.step(np.zeros(5, np.float32))[2]
    moved = {"initial_positions": np.array([[500e-9, 100e-9]]), "target_positions": [900e-9]}
    g.reset(seed=0, options=moved)
    jg.reset(seed=0, options=moved)
    obs, r2, te2, tr2, info2 = g.step(np.zeros(5, np.float32))
    assert not te2  # 400 nm away from the overridden target
    assert info2["average_error"] > 1e-7
    jout = jg.step(np.zeros(5, np.float32))
    assert te2 == jout[2]
    # The port's adapter computes in float32 by default, JAX's in float64.
    np.testing.assert_allclose(info2["average_error"], jout[4]["average_error"], rtol=1e-6)
