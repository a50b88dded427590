"""The JAX package's end-to-end training workflow
(``tests/e2e/test_training_workflow.py``) on the port, on the CPU, with the
shared fixtures of ``tests/fixtures/``: the ``easy_switching`` scenario, a
recorded pulse protocol replayed against ``analyze_episode``, and a
domain-randomized batch with per-env damping and anisotropy. JAX keys
become integer seeds; the randomized fields are drawn with numpy. The
random-policy rollout with ``summarize`` is in
``tests/test_torch_training_rollout.py`` (~50 s of eager plain-loop
substeps on its own: one file each keeps both under a minute).

The adapters run float64, as the JAX adapters do in the JAX test's
process (x64 on). The deterministic tests (thermal off) are also held
against the JAX package on the same numpy-made inputs, at the tolerance of
``tests/test_torch_env.py`` (rtol 1e-9; the vector observation's
steps-left entry at float32 rounding): the scenario's step and analysis,
the protocol's episode from the port's reset state handed to the JAX
adapter as options (the two packages draw resets from different streams),
and the randomized batch's step from the JAX env's reset state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.fixtures.device_configs import get_test_scenario
from tests.fixtures.sample_data import generate_pulse_protocol

import spintorque_tpu.envs.gym_adapter as J
import spintorque_tpu_torch.envs.gym_adapter as T
from spintorque_tpu.envs.spin_torque import SpinTorqueEnv as JEnv
from spintorque_tpu.envs.spin_torque import SpinTorqueEnvConfig as JConfig
from spintorque_tpu_torch import convert
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
STEPS_LEFT = 8  # the vector observation's float32 entry


def _obs_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    cols = np.arange(got.shape[-1]) != STEPS_LEFT
    np.testing.assert_allclose(got[..., cols], ref[..., cols], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., STEPS_LEFT], ref[..., STEPS_LEFT], rtol=2.0**-23)


def _step_close(got, want):
    _obs_close(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert got[2:4] == want[2:4]


def _scenario_env(package, sc, **kw):
    return package.GymSpinTorqueEnv(
        device_type=sc["device_type"], device_params=sc["device_params"],
        include_thermal_fluctuations=False, max_steps=sc["max_steps"], **kw,
    )


def test_easy_switching_scenario():
    sc = get_test_scenario("easy_switching")
    options = {"initial_state": sc["initial_state"], "target_state": sc["target_state"]}
    env = _scenario_env(T, sc, device="cpu", dtype="float64")
    ref = _scenario_env(J, sc, dtype="float64")
    obs, _ = env.reset(seed=0, options=options)
    _obs_close(obs, ref.reset(seed=0, options=options)[0])
    out = env.step(np.array([0.0, 1e-10]))
    _step_close(out, ref.step(np.array([0.0, 1e-10])))
    obs, r, te, tr, info = out
    assert te  # initial state aligned with target -> immediate success
    analysis = env.analyze_episode()
    assert analysis["success"] and analysis["switching_step"] == 1
    want = ref.analyze_episode()
    assert (analysis["success"], analysis["switching_step"]) == (want["success"],
                                                                 want["switching_step"])
    np.testing.assert_allclose(analysis["final_alignment"], want["final_alignment"], rtol=RTOL)


def test_protocol_evaluation():
    """Replay a recorded pulse protocol; episode analysis is consistent."""
    kw = dict(include_thermal_fluctuations=False, max_steps=10, dtype="float64")
    env = T.GymSpinTorqueEnv(device="cpu", **kw)
    env.reset(seed=3)
    # The JAX adapter starts from the same state.
    options = {"initial_state": env._state.m[0].numpy(),
               "target_state": env._state.target[0].numpy()}
    ref = J.GymSpinTorqueEnv(**kw)
    _obs_close(env.reset(seed=3, options=options)[0], ref.reset(seed=3, options=options)[0])
    protocol = generate_pulse_protocol(n_pulses=6, seed=4)
    total = 0.0
    for pulse in protocol:
        out = env.step(pulse.astype(np.float32))
        _step_close(out, ref.step(pulse.astype(np.float32)))
        obs, r, te, tr, info = out
        total += r
        if te or tr:
            break
    analysis = env.analyze_episode()
    np.testing.assert_allclose(
        analysis["average_reward"] * analysis["episode_length"], total, rtol=1e-6
    )
    want = ref.analyze_episode()
    assert analysis["episode_length"] == want["episode_length"] > 1
    np.testing.assert_allclose(analysis["average_reward"], want["average_reward"], rtol=RTOL)


def test_domain_randomized_batch():
    """Per-env heterogeneous device parameters in one batch."""
    B = 16
    rng = np.random.default_rng(0)
    damping = rng.uniform(0.005, 0.05, B)
    ku = rng.uniform(0.8e6, 2e6, B)
    env = SpinTorqueEnv(
        batch_size=B,
        config=SpinTorqueEnvConfig(include_thermal=False, max_duration=1e-10,
                                   dtype="float32"),
        device="cpu",
    )
    env.device_params = dataclasses.replace(
        env.device_params, damping=torch.tensor(damping, dtype=torch.float32),
        uniaxial_anisotropy=torch.tensor(ku, dtype=torch.float32),
    )
    state, obs = env.reset(2)
    state, ts = env.step(state, torch.zeros((B, 2)))
    assert np.isfinite(ts.obs.numpy()).all()

    # float64 against the JAX env from its reset state; the per-env fields
    # must reach the pulse (a uniform batch ends elsewhere).
    cfg = dict(include_thermal=False, max_duration=1e-10, dtype="float64")
    jenv = JEnv(batch_size=B, config=JConfig(use_pallas=False, **cfg))
    jenv.device_params = jenv.device_params.replace(
        damping=jnp.asarray(damping), uniaxial_anisotropy=jnp.asarray(ku))
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    leaves = {f.name: getattr(jstate, f.name) for f in dataclasses.fields(jstate)}
    leaves.pop("reward_stats")
    snapshot = dict(jax.tree.map(np.asarray, leaves), reward_stats={})
    jstate, jts = jenv.step(jstate, jnp.zeros((B, 2)))
    ms = []
    for randomized in (True, False):
        port = SpinTorqueEnv(batch_size=B, config=SpinTorqueEnvConfig(**cfg), device="cpu")
        if randomized:
            port.device_params = dataclasses.replace(
                port.device_params, damping=torch.tensor(damping),
                uniaxial_anisotropy=torch.tensor(ku))
        pstate, pts = port.step(convert.env_state_from_numpy(snapshot, device="cpu"),
                                torch.zeros((B, 2), dtype=torch.float64))
        ms.append(pstate.m.numpy())
        if randomized:
            _obs_close(pts.obs.numpy(), jts.obs)
            np.testing.assert_allclose(pts.reward.numpy(), np.asarray(jts.reward),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ms[0], np.asarray(jstate.m), rtol=RTOL, atol=ATOL)
    assert np.abs(ms[0] - ms[1]).max() > 1e-6
