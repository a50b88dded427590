"""The port's Gymnasium surface: adapters, wrappers and registration.

* gymnasium's own ``check_env`` on the four adapters, in every mode the JAX
  package's compliance test covers
  (``tests/integration/test_gym_api_compliance.py``), on the CPU in float32
  and float64. ``VectorSpinTorqueEnv`` returns arrays of flags, which the
  checker cannot take (it asserts ``truncated is False``), so it is checked
  at ``num_envs=1`` through a view that returns env 0's values, and its
  batched surface is checked beside that.
* Episode parity with the JAX adapters: thermal off, a fixed initial and
  target state (pattern, positions), float64, the same seeded actions;
  obs, reward, flags and info agree at rtol 1e-9 with the jitted JAX step
  (the vector observation's steps-left entry at float32 rounding, as in
  ``tests/test_torch_env.py``), and ``analyze_episode`` agrees.
* Both wrappers over a port adapter.
* Registry coexistence: the bare ids are the JAX package's, the
  ``spintorque_torch/`` ids the port's, and ``register_envs(force=True)``
  of either package leaves the other's ids alone.
* The configurations the adapters build are the ones ``chip_smoke.py``
  drives on the card.
"""

import subprocess
import sys
import warnings

import gymnasium as gym
import numpy as np
import pytest
import torch
from gymnasium.envs.registration import register, registry
from gymnasium.utils.env_checker import check_env

import spintorque_tpu.envs.gym_adapter as J
import spintorque_tpu_torch.envs.gym_adapter as T
from spintorque_tpu.registration import register_envs as jax_register_envs
from spintorque_tpu_torch.envs import (
    ArrayEnvConfig,
    EpisodeStatisticsWrapper,
    RobustEnvironmentWrapper,
    SkyrmionEnvConfig,
    SpinTorqueEnv,
    SpinTorqueEnvConfig,
)
from spintorque_tpu_torch.registration import NAMESPACE, register_envs
from spintorque_tpu_torch.utils.host import to_host

torch.set_num_threads(1)

FAST = dict(include_thermal_fluctuations=False, max_duration=2e-10, max_steps=8)


class _OneEnv(gym.Wrapper):
    """Env 0 of a VectorSpinTorqueEnv(num_envs=1), with one env's spaces
    and Python scalars for reward and flags."""

    def __init__(self, env):
        super().__init__(env)
        self.action_space = env.single_action_space
        self.observation_space = env.single_observation_space

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return _first(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(np.asarray(action)[None])
        info = {k: (v[0] if isinstance(v, np.ndarray) and v.ndim else v) for k, v in info.items()}
        info["final_observation"] = _first(info["final_observation"])
        return _first(obs), float(reward[0]), bool(terminated[0]), bool(truncated[0]), info


def _first(obs):
    return {k: v[0] for k, v in obs.items()} if isinstance(obs, dict) else obs[0]


CHECKED = [
    ("spin", dict(action_mode="continuous", **FAST)),
    ("spin", dict(action_mode="discrete", **FAST)),
    ("spin", dict(observation_mode="dict", **FAST)),
    ("spin", dict(FAST, include_thermal_fluctuations=True)),
    ("vector", dict(include_thermal_fluctuations=True, max_duration=2e-10, max_steps=8)),
    ("vector", dict(observation_mode="dict", action_mode="discrete", **FAST)),
    ("array", dict(array_size=(2, 2), observation_mode="array", max_steps=4)),
    ("array", dict(array_size=(2, 2), observation_mode="vector", max_steps=4)),
    ("array", dict(array_size=(2, 2), observation_mode="dict", max_steps=4,
                   coupling_update="simultaneous", action_mode="row")),
    ("skyrmion", dict(observation_mode="vector", max_steps=4)),
    ("skyrmion", dict(observation_mode="dict", max_steps=4, action_mode="discrete")),
]


def _adapter(kind, dtype, **kw):
    if kind == "spin":
        return T.GymSpinTorqueEnv(dtype=dtype, device="cpu", **kw)
    if kind == "vector":
        return _OneEnv(T.VectorSpinTorqueEnv(num_envs=1, dtype=dtype, device="cpu", **kw))
    if kind == "array":
        return T.GymSpinTorqueArrayEnv(dtype=dtype, device="cpu", **kw)
    return T.GymSkyrmionRacetrackEnv(dtype=dtype, device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,kw", CHECKED)
def test_adapters_pass_the_official_env_checker(kind, kw, dtype):
    env = _adapter(kind, dtype, **kw)
    with warnings.catch_warnings():
        # The checker warns about render modes and the like; failures raise.
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)
    obs, _ = env.reset(seed=5)
    assert all(np.asarray(v).dtype != np.float16 for v in (obs.values() if isinstance(obs, dict)
                                                             else [obs]))
    assert env.observation_space.contains(obs)


def test_vector_adapter_batch_surface():
    env = T.VectorSpinTorqueEnv(num_envs=6, seed=3, device="cpu", **FAST)
    obs, info = env.reset()
    again, _ = T.VectorSpinTorqueEnv(num_envs=6, seed=3, device="cpu", **FAST).reset()
    assert obs.shape == (6, 12) and obs.dtype == np.float32 and info == {}
    np.testing.assert_array_equal(obs, again)
    assert not np.array_equal(env.reset()[0], obs)  # the next reset of the sequence
    np.testing.assert_array_equal(env.reset(seed=3)[0], obs)
    rng = np.random.default_rng(0)
    ever_done = np.zeros(6, bool)
    for _ in range(FAST["max_steps"]):
        actions = np.stack([rng.uniform(-2e6, 2e6, 6), rng.uniform(0, 2e-10, 6)], -1)
        obs, reward, terminated, truncated, info = env.step(actions.astype(np.float32))
        assert obs.shape == (6, 12) and reward.shape == (6,) and reward.dtype == np.float32
        assert terminated.dtype == truncated.dtype == np.bool_
        assert info["final_observation"].shape == (6, 12) and "reward_components" not in info
        done = terminated | truncated
        # Done envs return their reset observation: step 0 of 8 left.
        np.testing.assert_array_equal(obs[done, 8], 1.0)
        ever_done |= done
    assert ever_done.all()  # each env succeeded or ran out of its 8 steps
    assert env.functional_env.config.autoreset


def test_unknown_kwargs_warn_and_integrator_knobs_route():
    e = T.GymSpinTorqueEnv(method="euler", noise_mode="physical", rk4_noise="per_stage",
                           max_substeps=64, bf16_rhs=True, device="cpu")
    cfg = e.unwrapped._env.config
    assert (cfg.method, cfg.noise_mode, cfg.rk4_noise, cfg.max_substeps, cfg.bf16_rhs) == (
        "euler", "physical", "per_stage", 64, True)
    info = e.get_solver_info()
    assert info["max_substeps"] == 64 and info["device"] == "cpu" and info["dtype"] == "float32"
    for cls, kw in ((T.GymSpinTorqueEnv, {}), (T.GymSpinTorqueArrayEnv, {}),
                    (T.GymSkyrmionRacetrackEnv, {}), (T.GymSpinTorqueEnv, {"use_pallas": False})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cls(not_a_real_knob=1, device="cpu", **kw).close()
        assert any("not_a_real_knob" in str(x.message) for x in w), [str(x.message) for x in w]
    e = T.GymSpinTorqueArrayEnv(coupling_update="simultaneous", device="cpu")
    assert e._env.config.coupling_update == "simultaneous"


def test_adapters_build_the_configs_chip_smoke_drives():
    """float32 on every device, whatever torch's default dtype."""
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert T.GymSpinTorqueEnv(device="cpu")._env.config == SpinTorqueEnvConfig(autoreset=False)
        assert T.VectorSpinTorqueEnv(num_envs=2, device="cpu")._env.config == SpinTorqueEnvConfig()
        assert T.GymSpinTorqueArrayEnv(device="cpu")._env.config == ArrayEnvConfig(autoreset=False)
        assert T.GymSkyrmionRacetrackEnv(device="cpu")._env.config == SkyrmionEnvConfig(
            autoreset=False)
    finally:
        torch.set_default_dtype(previous)


def _steps_left_close(got, ref, col, rtol):
    cols = np.arange(got.shape[-1]) != col
    np.testing.assert_allclose(got[cols], ref[cols], rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got[col], ref[col], rtol=2.0**-23)


def _info_close(got, ref, rtol):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k], dtype=float), np.asarray(ref[k], dtype=float),
                                   rtol=rtol, atol=rtol * 1e-12, err_msg=k)


def _obs_close(got, ref, rtol, steps_left=None):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=rtol * 1e-7, err_msg=k)
    elif steps_left is None:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)
    else:
        assert got.dtype == ref.dtype
        _steps_left_close(got, ref, steps_left, rtol)


def _episode(jenv, tenv, actions, options, steps_left):
    jobs, jinfo = jenv.reset(seed=1, options=options)
    tobs, tinfo = tenv.reset(seed=1, options=options)
    _obs_close(tobs, jobs, 1e-9, steps_left)
    _info_close(tinfo, jinfo, 1e-9)
    for a in actions:
        jout, tout = jenv.step(a), tenv.step(a)
        _obs_close(tout[0], jout[0], 1e-9, steps_left)
        np.testing.assert_allclose(tout[1], jout[1], rtol=1e-9, atol=1e-9)
        assert tout[2:4] == jout[2:4]
        _info_close(tout[4], jout[4], 1e-9)
        if tout[2] or tout[3]:
            break


@pytest.mark.parametrize("observation_mode", ["vector", "dict"])
def test_spin_torque_adapter_episode_matches_jax(observation_mode):
    kw = dict(FAST, dtype="float64", observation_mode=observation_mode, max_steps=10,
              success_threshold=0.999)
    jenv, tenv = J.GymSpinTorqueEnv(**kw), T.GymSpinTorqueEnv(device="cpu", **kw)
    rng = np.random.default_rng(4)
    actions = np.stack([rng.uniform(-2e6, 2e6, 10), rng.uniform(1e-12, 2e-10, 10)], -1)
    options = {"initial_state": [0.3, -0.2, 0.9], "target_state": [0.0, 0.0, -1.0]}
    _episode(jenv, tenv, actions, options, 8 if observation_mode == "vector" else None)
    got, ref = tenv.analyze_episode(), jenv.analyze_episode()
    assert got.keys() == ref.keys() and len(got["history"]) == len(ref["history"]) > 1
    for k in ("episode_length", "success", "switching_step"):
        assert got[k] == ref[k], k
    for k in ("total_energy", "final_alignment", "average_reward", "energy_efficiency"):
        assert got[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-30), k
    for g, r in zip(got["history"], ref["history"]):
        assert g["step"] == r["step"]
        np.testing.assert_allclose(g["magnetization"], r["magnetization"], rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(g["action"], r["action"])


@pytest.mark.parametrize("coupling_update", ["sequential", "simultaneous"])
def test_array_adapter_episode_matches_jax(coupling_update):
    kw = dict(array_size=(2, 3), dtype="float64", observation_mode="vector", max_steps=6,
              coupling_update=coupling_update)
    jenv, tenv = J.GymSpinTorqueArrayEnv(**kw), T.GymSpinTorqueArrayEnv(device="cpu", **kw)
    rng = np.random.default_rng(5)
    pattern = rng.normal(size=(2, 3, 3))
    pattern /= np.linalg.norm(pattern, axis=-1, keepdims=True)
    target = -pattern[::-1]
    actions = np.stack([rng.integers(0, 6, 6), rng.uniform(-2e6, 2e6, 6),
                        rng.uniform(1e-12, 5e-9, 6)], -1)
    _episode(jenv, tenv, actions, {"initial_pattern": pattern, "target_pattern": target},
             2 * 6 * 3 + 1)
    new_target = np.tile([0.0, 0.0, 1.0], (2, 3, 1))
    jenv.set_target_pattern(new_target)
    tenv.set_target_pattern(new_target)
    _obs_close(tenv.step(actions[0])[0], jenv.step(actions[0])[0], 1e-9, 2 * 6 * 3 + 1)


@pytest.mark.parametrize("action_mode", ["continuous", "discrete"])
def test_skyrmion_adapter_episode_matches_jax(action_mode):
    kw = dict(dtype="float64", n_skyrmions=2, include_thermal_fluctuations=False, max_steps=6,
              action_mode=action_mode, observation_mode="dict", seed=4)
    jenv, tenv = J.GymSkyrmionRacetrackEnv(**kw), T.GymSkyrmionRacetrackEnv(device="cpu", **kw)
    rng = np.random.default_rng(6)
    if action_mode == "discrete":
        actions = list(rng.integers(0, 45, 6))
    else:
        actions = np.concatenate([rng.uniform(-1e12, 1e12, (6, 2)),
                                  rng.uniform(-1e18, 1e18, (6, 2)),
                                  rng.uniform(1e-12, 2e-9, (6, 1))], -1)
    options = {"initial_positions": [[300e-9, 100e-9], [520e-9, 90e-9]],
               "target_positions": [250e-9, 700e-9]}
    _episode(jenv, tenv, actions, options, None)


def test_resets_follow_the_seed_sequence():
    env = T.GymSpinTorqueEnv(device="cpu", **FAST)
    first = env.reset(seed=7)[0]
    second = env.reset()[0]
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(env.reset(seed=7)[0], first)
    np.testing.assert_array_equal(env.reset()[0], second)
    fresh = T.GymSpinTorqueEnv(device="cpu", seed=7, **FAST)
    np.testing.assert_array_equal(fresh.reset()[0], first)
    assert not np.array_equal(env.reset(seed=8)[0], first)
    with pytest.raises(RuntimeError, match="reset"):
        T.GymSkyrmionRacetrackEnv(device="cpu").step(np.zeros(5))


def test_reports_and_render():
    env = T.GymSpinTorqueEnv(device="cpu", render_mode="rgb_array", **FAST)
    env.reset(seed=0)
    env.step(np.array([1e6, 1e-10]))
    report = env.get_health_report()
    assert report["status"] == "HEALTHY" and report["episode_steps"] == 1
    assert report["checks"]["compute"]["detail"] == "sum=5.0"
    stats = env.get_performance_stats()
    assert stats["backend"] == "cpu" and stats["solver"]["rk4_noise"] == "per_substep"
    assert stats["devices"] == 1  # a CPU env counts one device, card or none
    assert env.get_device_info()["device_type"] == "stt_mram"
    frame = env.render()
    assert frame.ndim == 3 and frame.shape[-1] == 3 and frame.dtype == np.uint8
    assert T.GymSpinTorqueEnv(device="cpu", **FAST).render() is None
    from spintorque_tpu_torch.utils.monitoring import default_health_monitor

    if not torch.cuda.is_available():  # the default device is the card
        assert default_health_monitor().run()["status"] == "CRITICAL"


def test_to_host_reads_nested_outputs():
    ts = SpinTorqueEnv(batch_size=3, device="cpu", observation_mode="dict").reset(seed=0)
    host = to_host({"state": [ts[0].m, (ts[0].step, 2.5)], "obs": ts[1]})
    assert isinstance(host["state"][0], np.ndarray) and host["state"][1][1] == 2.5
    assert host["obs"]["steps_remaining"].dtype == np.int32
    env = SpinTorqueEnv(batch_size=2, device="cpu")
    _, step = env.step(env.reset(seed=1)[0], np.zeros((2, 2)))
    host = to_host(step)
    assert type(host).__name__ == "TimeStep" and isinstance(host.reward, np.ndarray)


@pytest.mark.parametrize("kind,kw,action", [
    ("spin", dict(FAST, observation_mode="dict"), np.array([1e6, 1e-10])),
    ("array", dict(array_size=(2, 2), observation_mode="dict", max_steps=4),
     np.array([1.0, 2e6, 1e-9])),
    ("skyrmion", dict(observation_mode="dict", max_steps=4, include_thermal_fluctuations=False),
     np.array([1e11, 0.0, 0.0, 0.0, 1e-9])),
])
def test_writing_into_an_observation_leaves_the_env_alone(kind, kw, action):
    envs = [_adapter(kind, "float32", **kw) for _ in range(2)]
    scribbled, clean = (env.reset(seed=3)[0] for env in envs)
    for v in scribbled.values():
        v[...] = 7  # the adapters' arrays on the CPU are copies, not the state's memory
    got, want = (env.step(action)[0] for env in envs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not np.array_equal(scribbled[next(iter(want))], clean[next(iter(want))])


def test_robust_wrapper():
    env = RobustEnvironmentWrapper(T.GymSpinTorqueEnv(device="cpu", **FAST))
    obs, _ = env.reset(seed=0)
    assert obs.shape == (12,)
    obs, reward, *_ = env.step(np.array([np.nan, 1e-10], dtype=np.float32))  # sanitized
    assert np.isfinite(obs).all() and np.isfinite(reward)
    # An action torch cannot take raises inside: the fallback answers.
    obs2, reward, terminated, truncated, info = env.step(np.array(["bad", "action"]))
    assert reward == -1.0 and truncated and not terminated and "error" in info
    np.testing.assert_array_equal(obs2, obs)
    stats = env.get_stats()
    assert stats["steps"] == 2 and stats["step_failures"] == stats["fallbacks_used"] == 1
    assert env.monitor.get_health_report()["status"] == "WARNING"


def test_episode_statistics_wrapper():
    env = EpisodeStatisticsWrapper(T.GymSkyrmionRacetrackEnv(device="cpu", max_steps=3))
    env.reset(seed=0)
    total = 0.0
    for _ in range(3):
        _, reward, terminated, truncated, info = env.step(np.array([1e11, 0, 0, 0, 1e-9]))
        total += reward
    assert truncated and info["episode"]["l"] == 3
    assert info["episode"]["r"] == pytest.approx(total)
    env.reset()
    assert env.history == [{"return": pytest.approx(total), "length": 3}]


def _entry(env_id):
    return registry[env_id].entry_point


def test_registry_coexistence():
    names = ("SpinTorque-v0", "SpinTorqueArray-v0", "SkyrmionRacetrack-v0")
    register_envs()
    jax_register_envs(force=True)
    for name in names:
        assert _entry(name).startswith("spintorque_tpu.envs.")
        assert _entry(f"{NAMESPACE}/{name}").startswith("spintorque_tpu_torch.envs.")
    assert registry[f"{NAMESPACE}/SpinTorque-v0"].max_episode_steps == 100
    assert registry[f"{NAMESPACE}/SpinTorqueArray-v0"].kwargs == {"array_size": (4, 4)}

    e = gym.make("SpinTorque-v0")
    try:
        assert type(e.unwrapped) is J.GymSpinTorqueEnv
    finally:
        e.close()
    e = gym.make(f"{NAMESPACE}/SpinTorque-v0", device="cpu", **FAST)
    try:
        assert type(e.unwrapped) is T.GymSpinTorqueEnv
        e.reset(seed=0)
        _, r, *_ = e.step(e.action_space.sample())
        assert np.isfinite(r)
    finally:
        e.close()
    e = gym.make(f"{NAMESPACE}/SkyrmionRacetrack-v0", device="cpu")
    assert e.spec.max_episode_steps == 150 and type(e.unwrapped) is T.GymSkyrmionRacetrackEnv

    # Another package takes a namespaced id: force reclaims it and leaves
    # the JAX package's bare ids alone, and the JAX force leaves ours.
    register(id=f"{NAMESPACE}/SpinTorque-v0", entry_point="elsewhere:Env", max_episode_steps=1)
    register_envs()
    assert _entry(f"{NAMESPACE}/SpinTorque-v0") == "elsewhere:Env"
    register_envs(force=True)
    assert _entry(f"{NAMESPACE}/SpinTorque-v0").startswith("spintorque_tpu_torch.")
    jax_register_envs(force=True)
    for name in names:
        assert _entry(name).startswith("spintorque_tpu.envs.")
        assert _entry(f"{NAMESPACE}/{name}").startswith("spintorque_tpu_torch.envs.")


def test_the_package_imports_without_gymnasium():
    """As on a machine without gymnasium: the functional envs import, the
    adapters and wrappers are None and no id is registered."""
    code = (
        "import sys; sys.modules['gymnasium'] = None\n"
        "import spintorque_tpu_torch, spintorque_tpu_torch.registration as r\n"
        "from spintorque_tpu_torch import envs\n"
        "assert envs.GymSpinTorqueEnv is None and envs.RobustEnvironmentWrapper is None\n"
        "assert envs.SpinTorqueArrayEnv is not None and not r._REGISTERED\n"
        "state, obs = envs.SkyrmionRacetrackEnv(device='cpu').reset(seed=0)\n"
        "print(tuple(obs.shape))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "(1, 10)", proc.stdout + proc.stderr
