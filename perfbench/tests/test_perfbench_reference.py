"""The plain reference against the port's plain CPU step, and its CUDA-graph
replay against its own eager loop on the card."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.lib import check, manifest, program
from perfbench.reference import spintorque as ref


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _actions(batch, seed, zero=0.25, hi=3e-11):
    g = np.random.default_rng(seed)
    u = g.random((batch, 3))
    a = np.stack([-2e6 + 4e6 * u[:, 0], 1e-12 + (hi - 1e-12) * u[:, 1]], -1)
    a[:, 0] = np.where(u[:, 2] < zero, 0.0, a[:, 0])
    return torch.as_tensor(a.astype(np.float32))


@pytest.mark.parametrize("name", ["spintorque-v0-thermal", "spintorque-v0-deterministic"])
def test_reference_equals_the_port_plain_step_bit_for_bit(name):
    config = manifest.config(name)
    batch, seed = 32, 11
    env = program.make_env(config, batch, torch.device("cpu"))
    renv = ref.make_env(config, torch.device("cpu"))
    state, _ = env.reset(seed)
    want0 = ref.reset(renv, seed, batch, torch.device("cpu"))
    for f in ref.State._fields:
        assert _bits_equal(getattr(state, f), getattr(want0, f)), f
    rows = torch.arange(batch)
    inputs, outs = [], []
    for k in range(3):
        action = _actions(batch, k)
        nxt, ts = env.step(state, action)
        inputs.append(ref.StepInput(check._state(state), action, state.seed, state.counter,
                                    batch, rows))
        outs.append((nxt, ts))
        state = nxt
    want = ref.steps(renv, inputs)
    got_m = torch.cat([ts.info["final_magnetization"] for _, ts in outs])
    assert _bits_equal(got_m, want.m_new)
    assert torch.equal(torch.cat([~ts.info["simulation_success"] for _, ts in outs]),
                       want.failed)
    assert _bits_equal(torch.cat([ts.obs for _, ts in outs]), want.obs)
    assert _bits_equal(torch.cat([ts.reward for _, ts in outs]), want.reward)
    for f in ref.State._fields:
        assert _bits_equal(torch.cat([getattr(n, f) for n, _ in outs]),
                           getattr(want.next_state, f)), f
    # Pulses that leave the pole's fallback: some rows with the torque off
    # end away from +z, so the comparison sees real dynamics.
    assert bool(((want.m_new[:, 2] - 1.0).abs() > 1e-3).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spintorque-v0-thermal", "spintorque-v0-deterministic"])
def test_graph_replay_equals_the_eager_loop_on_the_card(card, name):
    env = ref.make_env(manifest.config(name), card)
    g = torch.Generator(device=card).manual_seed(7)
    n = 4096
    m = torch.randn((n, 3), generator=g, device=card)
    m = m / m.norm(dim=-1, keepdim=True)
    span = 1e-12 + 3e-10 * torch.rand(n, generator=g, device=card)
    cur = torch.where(torch.rand(n, generator=g, device=card) < 0.5, 0.0,
                      2e6 * torch.rand(n, generator=g, device=card))
    keys = (torch.full((n,), 12345, dtype=torch.int64, device=card),
            torch.full((n,), 678, dtype=torch.int64, device=card))
    out = [ref.pulse(m.t().contiguous().unbind(0), span, cur, env.device,
                     thermal=env.include_thermal, temperature=env.temperature, keys=keys,
                     env_index=torch.arange(n, device=card), max_step=env.max_step,
                     max_substeps=env.max_substeps, graph=graph) for graph in (False, True)]
    assert all(_bits_equal(a, b) for a, b in zip(out[0].m, out[1].m))
    assert torch.equal(out[0].failed, out[1].failed)


def test_the_state_fields_are_the_port_state_fields():
    from spintorque_tpu_torch.envs.spin_torque import EnvState

    names = {f.name for f in dataclasses.fields(EnvState)}
    assert set(ref.State._fields) <= names
