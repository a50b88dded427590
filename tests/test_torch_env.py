"""The port's SpinTorqueEnv against the JAX package's, step by step.

Both envs run float64 with thermal noise off, from the same state: the JAX
env resets, its state leaves go to numpy with ``jax.tree``, and
``spintorque_tpu_torch.convert`` injects them into the port. The same
actions (seeded numpy) then drive both. obs, reward, terminated, truncated,
step_energy and m must agree at rtol 1e-9 (atol 1e-12 for values that
cancel to near zero, as the alignment improvement does).

One exception: the steps-remaining entry of the vector observation is a
float32 quantity in the JAX package ((max_steps - step) / max_steps divides
int32 by int), which its jitted step rounds through the reciprocal of
max_steps and the port (like JAX run op by op) by true division. That entry
is held at float32 rounding, rtol 2^-23.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.devices import make_device_params as jax_make_device_params
from spintorque_tpu.envs.spin_torque import SpinTorqueEnv as JEnv
from spintorque_tpu.envs.spin_torque import SpinTorqueEnvConfig as JConfig
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.devices import DEVICE_TYPES, make_device_params
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig

torch.set_num_threads(1)

B = 16
RTOL, ATOL = 1e-9, 1e-12
MAX_DURATION = 2e-10  # keeps every pulse under 201 substeps


def _config_kw(**kw):
    base = dict(dtype="float64", include_thermal=False, autoreset=False,
                max_duration=MAX_DURATION)
    base.update(kw)
    return base


def _jax_state_to_numpy(js):
    leaves = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    stats = leaves.pop("reward_stats")
    d = jax.tree.map(np.asarray, leaves)
    d["reward_stats"] = {
        name: jax.tree.map(np.asarray, {f.name: getattr(st, f.name) for f in dataclasses.fields(st)})
        for name, st in stats.items()
    }
    return d


def _pair(seed=0, **kw):
    jenv = JEnv(batch_size=B, config=JConfig(use_pallas=False, **_config_kw(**kw)))
    tenv = SpinTorqueEnv(batch_size=B, config=SpinTorqueEnvConfig(**_config_kw(**kw)), device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(seed))
    tstate = convert.env_state_from_numpy(_jax_state_to_numpy(jstate), device="cpu")
    return jenv, jstate, tenv, tstate


STEPS_LEFT = 8  # column of the vector observation


def _close(got, ref, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=name)


def _close_obs(got, ref, name):
    got, ref = got.numpy(), np.asarray(ref)
    cols = np.arange(got.shape[-1]) != STEPS_LEFT
    _close(got[:, cols], ref[:, cols], name)
    np.testing.assert_allclose(
        got[:, STEPS_LEFT], ref[:, STEPS_LEFT], rtol=2.0**-23, atol=0, err_msg=name
    )


def _actions(mode, steps, seed=1):
    rng = np.random.default_rng(seed)
    if mode == "discrete":
        a = rng.integers(0, 20, size=(steps, B))
        a[0, :3] = [-3, 25, 19]  # out-of-range indices clip
        return a
    current = np.where(rng.random((steps, B)) < 0.5,
                       rng.uniform(-2e6, 2e6, (steps, B)), rng.uniform(-100.0, 100.0, (steps, B)))
    duration = rng.uniform(1e-12, MAX_DURATION, (steps, B))
    a = np.stack([current, duration], -1)
    a[0, 3] = [np.nan, 1e-10]  # the NaN scrub
    a[0, 4] = [1e5, np.inf]
    a[0, 5] = [5e6, 1.0]  # clipped to max_current, max_duration
    return a


@pytest.mark.parametrize(
    "action_mode,observation_mode",
    [("continuous", "vector"), ("discrete", "vector"), ("continuous", "dict")],
)
def test_step_matches_jax(action_mode, observation_mode):
    _step_matches_jax(action_mode, observation_mode)


@pytest.mark.parametrize(
    "device_type,method",
    [(d, m) for d in DEVICE_TYPES for m in ("euler", "heun", "rk4")
     if (d, m) != ("stt_mram", "rk4")],  # the defaults: test_step_matches_jax
)
def test_step_matches_jax_on_every_device_and_method(device_type, method):
    _step_matches_jax("continuous", "vector", device_type=device_type, method=method)


def _step_matches_jax(action_mode, observation_mode, **kw):
    jenv, jstate, tenv, tstate = _pair(action_mode=action_mode, observation_mode=observation_mode,
                                       **kw)
    for k, action in enumerate(_actions(action_mode, 5)):
        jstate, jts = jenv.step(jstate, jnp.asarray(action))
        tstate, tts = tenv.step(tstate, torch.tensor(action))
        if observation_mode == "vector":
            _close_obs(tts.obs, jts.obs, f"obs step {k}")
        else:
            assert set(tts.obs) == set(jts.obs)
            for key in jts.obs:
                _close(tts.obs[key], jts.obs[key], f"obs[{key}] step {k}")
        _close(tts.reward, jts.reward, f"reward step {k}")
        np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
        np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
        _close(tts.info["step_energy"], jts.info["step_energy"], f"step_energy step {k}")
        _close(tstate.m, jstate.m, f"m step {k}")
        np.testing.assert_array_equal(
            tts.info["simulation_success"].numpy(), np.asarray(jts.info["simulation_success"])
        )
    assert tstate.counter == 5


def test_autoreset_resets_exactly_the_done_envs():
    jenv, jstate, tenv, tstate = _pair(autoreset=True, max_steps=10)
    # Envs 0-3 are on their last step (truncate); envs 4-7 sit on their
    # target and get a negligible pulse (success).
    np_state = convert.env_state_to_numpy(tstate)
    np_state["step"][:4] = 9
    np_state["m"][4:8] = np_state["target"][4:8]
    tstate = convert.env_state_from_numpy(np_state, device="cpu")
    jstate = jstate.replace(step=jnp.asarray(np_state["step"]), m=jnp.asarray(np_state["m"]))
    action = _actions("continuous", 1, seed=4)[0]
    action[4:8] = [1.0, 1e-12]

    jnext, jts = jenv.step(jstate, jnp.asarray(action))
    tnext, tts = tenv.step(tstate, torch.tensor(action))

    done = (tts.terminated | tts.truncated).numpy()
    np.testing.assert_array_equal(done, np.asarray(jts.terminated | jts.truncated))
    assert done[:8].all() and not done.all()
    _close_obs(tts.info["final_observation"], jts.info["final_observation"], "final_observation")

    # Done envs restart; the others carry on exactly as in the JAX env.
    assert (tnext.step.numpy()[done] == 0).all()
    for name in ("total_energy", "last_current", "last_duration", "episode_return"):
        assert (getattr(tnext, name).numpy()[done] == 0.0).all(), name
    np.testing.assert_allclose(np.linalg.norm(tnext.m.numpy()[done], axis=-1), 1.0, rtol=1e-12)
    assert np.isin(np.abs(tnext.target.numpy()[done][:, 2]), [1.0]).all()
    for name in ("m", "target", "step", "total_energy", "last_current", "episode_return"):
        _close(getattr(tnext, name).numpy()[~done], np.asarray(getattr(jnext, name))[~done], name)
    # The returned obs is the reset obs for done envs, the step obs otherwise.
    reset_obs = tenv.observe(tnext).numpy()
    np.testing.assert_array_equal(tts.obs.numpy()[done], reset_obs[done])
    np.testing.assert_array_equal(
        tts.obs.numpy()[~done], tts.info["final_observation"].numpy()[~done]
    )


@pytest.mark.parametrize("device_type", DEVICE_TYPES)
def test_convert_round_trips_device_params(device_type):
    jp = jax_make_device_params(device_type, dtype=jnp.float64)
    d = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    tp = convert.device_params_from_numpy(d, device="cpu")
    back = convert.params_to_numpy(tp)
    assert set(back) == set(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    # The port's own defaults are the JAX package's.
    own = convert.params_to_numpy(make_device_params(device_type, dtype=torch.float64, device="cpu"))
    for k in d:
        np.testing.assert_array_equal(own[k], d[k], err_msg=k)
    lp = convert.llgs_params_from_numpy(convert.params_to_numpy(tp.llgs()), device="cpu")
    for k, v in convert.params_to_numpy(lp).items():
        np.testing.assert_array_equal(v, d[k], err_msg=k)


def test_convert_round_trips_env_state_with_reward_stats():
    stats_cfg = {
        "success": {"weight": 10.0, "function": "success", "normalize": "running_std"},
        "progress": {"weight": 1.0, "function": "progress", "normalize": "unit_range"},
    }
    jenv = JEnv(batch_size=B, reward_components=stats_cfg,
                config=JConfig(use_pallas=False, **_config_kw()))
    tenv = SpinTorqueEnv(batch_size=B, reward_components=stats_cfg,
                         config=SpinTorqueEnvConfig(**_config_kw()), device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    d = _jax_state_to_numpy(jstate)
    tstate = convert.env_state_from_numpy(d, device="cpu")
    back = convert.env_state_to_numpy(tstate)
    for k in ("m", "target", "step", "total_energy", "key"):
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert set(back["reward_stats"]) == {"success", "progress"}
    for name, st in d["reward_stats"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(back["reward_stats"][name][k], v, err_msg=f"{name}.{k}")
    # The running statistics then evolve as the JAX env's.
    action = _actions("continuous", 2, seed=8)
    for a in action:
        jstate, jts = jenv.step(jstate, jnp.asarray(a))
        tstate, tts = tenv.step(tstate, torch.tensor(a))
        _close(tts.reward, jts.reward, "reward")
    for name, st in tstate.reward_stats.items():
        for f in ("count", "mean", "m2", "min", "max"):
            _close(getattr(st, f), getattr(jstate.reward_stats[name], f), f"{name}.{f}")


def test_reset_and_thermal_step_on_cpu():
    env = SpinTorqueEnv(batch_size=8, device="cpu", max_duration=MAX_DURATION)
    s1, o1 = env.reset(seed=11)
    s2, o2 = env.reset(seed=11)
    assert o1.shape == (8, env.observation_size)
    assert torch.equal(o1, o2)
    assert not torch.equal(env.reset(seed=12)[1], o1)
    action = torch.tensor(_actions("continuous", 1, seed=2)[0, :8], dtype=torch.float32)
    n1, t1 = env.step(s1, action)
    n2, t2 = env.step(s2, action)
    assert torch.equal(t1.obs, t2.obs)  # the Philox key comes from (seed, counter)
    assert torch.isfinite(t1.obs).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(n1.m, dim=-1).numpy(), 1.0, atol=1e-6)
    env16 = SpinTorqueEnv(batch_size=2, device="cpu", max_duration=MAX_DURATION, bf16_rhs=True)
    _, t16 = env16.step(env16.reset(seed=11)[0], action[:2])
    assert torch.isfinite(t16.obs).all()
    with pytest.raises(ValueError):
        SpinTorqueEnv(batch_size=2, device="meta")


def test_env_defaults_to_the_card():
    """The entry point runs on the card unless the caller asks for the CPU
    (or passes a mesh, whose device it takes)."""
    assert inspect.signature(SpinTorqueEnv).parameters["device"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpinTorqueEnv(batch_size=2)
