"""The spans and counters of the array env (SpinTorqueArray-v0) on the CPU:
each step records ``array.step`` with its phases under it while tracing
is on and nothing while it is off, its counters count whatever the
switch, and tracing changes no bit of what a step returns.

Every test takes deltas of the process-wide store (``PROFILER``), which
the other tests of a worker share, and leaves the switch as it found it.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from spintorque_tpu_torch.envs import ArrayEnvConfig, SpinTorqueArrayEnv
from spintorque_tpu_torch.utils.profiling import (
    PROFILER,
    SPAN_NAMES,
    counter,
    tracing,
    tracing_enabled,
)

torch.set_num_threads(1)

B = 4
CHILDREN = {"array.decode", "array.sweep", "array.reward", "array.observe", "array.reset"}


def _env(coupling_update="sequential", **kw):
    return SpinTorqueArrayEnv(batch_size=B, device="cpu",
                              config=ArrayEnvConfig(rows=3, cols=4, max_steps=2,
                                                    coupling_update=coupling_update, **kw))


def _action(seed, n):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((3, B), generator=g)
    return torch.stack([torch.floor(u[0] * n), -2e6 + 4e6 * u[1], 1e-12 + 5e-9 * u[2]], -1)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]
    return [torch.tensor(x)] if isinstance(x, (int, float, bool)) else []


@pytest.mark.parametrize("coupling_update", ["sequential", "simultaneous"])
def test_a_traced_step_records_its_phases_under_array_step(coupling_update):
    env = _env(coupling_update)
    state, _ = env.reset(5)
    n = env.config.n_devices
    steps, updates = counter("array.steps").count, counter("array.device_updates").count
    since = len(PROFILER.spans())
    with tracing():
        state, _ = env.step(state, _action(1, n))
    spans = PROFILER.spans()[since:]
    assert {r.name for r in spans} <= set(SPAN_NAMES)
    roots = [r for r in spans if r.parent is None]
    assert [r.name for r in roots] == ["array.step"]
    under = sorted(r.name for r in spans if r.parent == "array.step")
    assert under == sorted(CHILDREN)
    # The auto-reset's observation lies under the reset.
    assert [r.parent for r in spans if r.name == "array.observe"].count("array.reset") == 1
    root = roots[0]
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in spans)
    assert sum(r.self_ns for r in spans) == root.end_ns - root.start_ns
    assert counter("array.steps").count == steps + 1
    assert counter("array.device_updates").count == updates + n


def test_tracing_off_records_no_span_and_counts_all_the_same():
    assert not tracing_enabled()
    env = _env()
    state, _ = env.reset(5)
    n = env.config.n_devices
    since = len(PROFILER.spans())
    updates = counter("array.device_updates").count
    for k in range(3):
        state, _ = env.step(state, _action(k, n))
    assert PROFILER.spans()[since:] == []
    assert counter("array.device_updates").count == updates + 3 * n


@pytest.mark.parametrize("coupling_update", ["sequential", "simultaneous"])
def test_a_traced_step_equals_an_untraced_one_bit_for_bit(coupling_update):
    """Three steps over an episode's end (max_steps 2), so the auto-reset
    runs: state and outputs in int32 bits."""
    env = _env(coupling_update)
    n = env.config.n_devices
    runs = []
    for traced in (False, True):
        state, _ = env.reset(9)
        out = []
        for k in range(3):
            if traced:
                with tracing():
                    state, ts = env.step(state, _action(k, n))
            else:
                state, ts = env.step(state, _action(k, n))
            out.append((state, ts))
        runs.append(_leaves(out))
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
