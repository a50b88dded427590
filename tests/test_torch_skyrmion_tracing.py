"""The spans and counters of the racetrack env (SkyrmionRacetrack-v0) on the
CPU: each step records ``racetrack.step`` with its phases under it while
tracing is on and nothing while it is off, its counters count whatever the
switch, and tracing changes no bit of what a step returns.

Every test takes deltas of the process-wide store (``PROFILER``), which
the other tests of a worker share, and leaves the switch as it found it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.envs import SkyrmionEnvConfig, SkyrmionRacetrackEnv
from spintorque_tpu_torch.envs import step_graph as sg
from spintorque_tpu_torch.utils.profiling import (
    PROFILER,
    SPAN_NAMES,
    counter,
    tracing,
    tracing_enabled,
)

torch.set_num_threads(1)

B = 4
SPANS = {"racetrack.step", "racetrack.replay", "racetrack.decode", "racetrack.forces",
         "racetrack.substeps", "racetrack.reward", "racetrack.observe", "racetrack.reset"}
CHILDREN = SPANS - {"racetrack.step", "racetrack.replay"}
COUNTERS = ("racetrack.steps", "racetrack.graph_captures", "racetrack.graph_replays",
            "racetrack.eager_steps")


def _env(mode="discrete", **kw):
    return SkyrmionRacetrackEnv(batch_size=B, device="cpu",
                                config=SkyrmionEnvConfig(action_mode=mode, max_steps=2, **kw))


def _action(mode, seed):
    rng = np.random.default_rng(seed)
    if mode == "discrete":
        return torch.as_tensor(rng.integers(0, 45, B))
    return torch.as_tensor(np.concatenate([rng.uniform(-1e11, 1e11, (B, 2)),
                                           rng.uniform(-1e18, 1e18, (B, 2)),
                                           rng.uniform(0.0, 2e-9, (B, 1))], -1))


def test_span_names_hold_every_racetrack_span():
    assert SPANS <= set(SPAN_NAMES)


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_a_traced_step_records_its_phases_under_racetrack_step(mode):
    env = _env(mode)
    state, _ = env.reset(5)
    steps = counter("racetrack.steps").count
    since = len(PROFILER.spans())
    with tracing():
        state, _ = env.step(state, _action(mode, 1))
    spans = PROFILER.spans()[since:]
    assert {r.name for r in spans} <= SPANS
    roots = [r for r in spans if r.parent is None]
    assert [r.name for r in roots] == ["racetrack.step"]
    under = sorted(r.name for r in spans if r.parent == "racetrack.step")
    assert under == sorted(CHILDREN)
    # The auto-reset's observation lies under the reset.
    assert [r.parent for r in spans if r.name == "racetrack.observe"].count("racetrack.reset") == 1
    root = roots[0]
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in spans)
    assert sum(r.self_ns for r in spans) == root.end_ns - root.start_ns
    assert counter("racetrack.steps").count == steps + 1


def test_tracing_off_records_no_span_and_counts_all_the_same():
    assert not tracing_enabled()
    env = _env()
    state, _ = env.reset(5)
    before = {name: counter(name).count for name in COUNTERS}
    since = len(PROFILER.spans())
    for k in range(3):
        state, _ = env.step(state, _action("discrete", k))
    assert PROFILER.spans()[since:] == []
    d = {name: counter(name).count - before[name] for name in COUNTERS}
    # On the CPU every step is eager: steps = replays + eager steps.
    assert d == {"racetrack.steps": 3, "racetrack.graph_captures": 0,
                 "racetrack.graph_replays": 0, "racetrack.eager_steps": 3}


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_a_traced_racetrack_step_equals_an_untraced_one_bit_for_bit(mode):
    """Three steps over an episode's end (max_steps 2), so the auto-reset
    runs: state and outputs in int32 bits."""
    env = _env(mode)
    runs = []
    for traced in (False, True):
        state, _ = env.reset(9)
        out = []
        for k in range(3):
            if traced:
                with tracing():
                    state, ts = env.step(state, _action(mode, k))
            else:
                state, ts = env.step(state, _action(mode, k))
            out.append((state, ts))
        leaves = []
        runs.append((sg.flatten(tuple(out), leaves), leaves))
    (spec_a, a), (spec_b, b) = runs
    assert spec_a == spec_b and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)
