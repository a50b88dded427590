"""An env step of the port is a function of its state.

Each of the three envs (SpinTorque-v0, the crossbar array, the skyrmion
racetrack) is stepped twice from one state with one action, thermal noise
and auto-reset on, with episodes short enough that some envs reset in that
step: both calls must give the same outputs and next states bit for bit,
and leave the given state unchanged. Every draw of step k is keyed by the
state's (seed, k): the pulse's thermal stream by derive_seed(seed, k), the
auto-reset draws and the racetrack's kicks by their own stream tags. The
distribution of those draws is held to the JAX package by the env tests
(tests/test_torch_env.py, test_torch_skyrmion_env.py,
test_torch_array_env.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.envs import (
    ArrayEnvConfig,
    SkyrmionEnvConfig,
    SkyrmionRacetrackEnv,
    SpinTorqueArrayEnv,
    SpinTorqueEnv,
    SpinTorqueEnvConfig,
)
from spintorque_tpu_torch.ops.philox import (
    KICK_STREAM,
    RESET_STREAM,
    derive_seed,
    step_generator,
)

torch.set_num_threads(1)

B = 32


def _leaves(x, path=""):
    """(path, leaf) pairs of a state, TimeStep, dict or tuple."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}[{k}]")
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def assert_same(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def _spin_torque():
    env = SpinTorqueEnv(batch_size=B, device="cpu", config=SpinTorqueEnvConfig(
        max_steps=2, max_duration=2e-10, success_threshold=0.95))
    g = torch.Generator().manual_seed(1)
    actions = torch.stack([4e6 * torch.rand(B, generator=g) - 2e6,
                           2e-10 * torch.rand(B, generator=g)], -1)
    return env, actions


def _array():
    env = SpinTorqueArrayEnv(batch_size=B, device="cpu", config=ArrayEnvConfig(
        rows=2, cols=2, max_steps=2, observation_mode="vector"))
    g = torch.Generator().manual_seed(2)
    actions = torch.stack([torch.randint(0, 4, (B,), generator=g).float(),
                           4e6 * torch.rand(B, generator=g) - 2e6,
                           1e-9 * torch.rand(B, generator=g)], -1)
    return env, actions


def _racetrack():
    env = SkyrmionRacetrackEnv(batch_size=B, device="cpu", config=SkyrmionEnvConfig(
        n_skyrmions=2, max_steps=2))
    g = torch.Generator().manual_seed(3)
    actions = torch.cat([2e11 * torch.rand(B, 4, generator=g) - 1e11,
                         1e-9 * torch.rand(B, 1, generator=g)], -1)
    return env, actions


ENVS = {"spin_torque": _spin_torque, "array": _array, "racetrack": _racetrack}


@pytest.mark.parametrize("name", list(ENVS))
def test_stepping_one_state_twice_gives_the_same_bits(name):
    env, actions = ENVS[name]()
    state, _ = env.reset(seed=123)
    state, _ = env.step(state, actions)  # envs still in their first episode truncate at step 2
    before = [(p, x.clone() if isinstance(x, torch.Tensor) else x) for p, x in _leaves(state)]
    first = env.step(state, actions)
    second = env.step(state, actions)
    done = first[1].terminated | first[1].truncated
    assert bool(done.any()), "no env reset in the step"
    assert_same(first, second)
    for (path, x), (_, y) in zip(before, _leaves(state)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), path
    # The step's draws come from (seed, counter): the next step draws anew.
    nxt = env.step(first[0], actions)
    assert first[0].counter == 2 and nxt[0].counter == 3
    again = env.step(first[0], actions)
    assert_same(nxt, again)


@pytest.mark.parametrize("name", list(ENVS))
def test_auto_reset_draws_depend_on_the_counter(name):
    env, actions = ENVS[name]()
    state, _ = env.reset(seed=5)
    state, _ = env.step(state, actions)
    a, _ = env.step(state, actions)
    b, _ = env.step(dataclasses.replace(state, counter=state.counter + 7), actions)
    field = {"spin_torque": "m", "array": "pattern", "racetrack": "positions"}[name]
    assert not torch.equal(getattr(a, field), getattr(b, field))


def test_racetrack_kicks_are_keyed_by_the_state():
    env = SkyrmionRacetrackEnv(batch_size=B, device="cpu", config=SkyrmionEnvConfig(
        autoreset=False, include_pinning=False))
    state, _ = env.reset(seed=9)
    action = torch.zeros(B, 5)
    action[:, 4] = 1e-9
    one, _ = env.step(state, action)
    two, _ = env.step(state, action)
    other, _ = env.step(dataclasses.replace(state, counter=1), action)
    assert torch.equal(one.velocities, two.velocities)
    assert not torch.equal(one.velocities, other.velocities)
    # A seeded env replays its episode: no state outside (seed, counter).
    again, _ = env.step(env.reset(seed=9)[0], action)
    assert torch.equal(one.velocities, again.velocities)


def test_step_streams_never_share_the_pulse_key():
    seeds = [0, 1, 2**63 + 7, 2**64 - 1]
    keys = {}
    for seed in seeds:
        for counter in range(64):
            keys[("pulse", seed, counter)] = derive_seed(seed, counter)
            for tag in (RESET_STREAM, KICK_STREAM):
                keys[(tag, seed, counter)] = derive_seed(derive_seed(seed, counter), tag)
    assert len(set(keys.values())) == len(keys)
    a = torch.rand(8, generator=step_generator(3, 4, RESET_STREAM, "cpu"))
    b = torch.rand(8, generator=step_generator(3, 4, RESET_STREAM, "cpu"))
    c = torch.rand(8, generator=step_generator(3, 4, KICK_STREAM, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_auto_reset_states_are_unit_vectors_and_targets():
    env, actions = _spin_torque()
    state, _ = env.reset(seed=7)
    state, _ = env.step(state, actions)
    nxt, ts = env.step(state, actions)
    done = (ts.terminated | ts.truncated).numpy()
    assert done.sum() >= B // 2
    np.testing.assert_allclose(torch.linalg.vector_norm(nxt.m, dim=-1).numpy(), 1.0, atol=1e-6)
    assert set(np.abs(nxt.target[:, 2].numpy()).tolist()) == {1.0}
    assert (nxt.step.numpy()[done] == 0).all()
