"""The port's tracing facility (``spintorque_tpu_torch.utils.profiling``):
spans, counters, device counts and the profiler's annotations, and the
spans of the env step and the PPO update on the CPU.

Every test takes deltas of the process-wide store (``PROFILER``), which
the other tests of a worker share, and leaves the switch as it found it.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from spintorque_tpu_torch.envs.spin_torque import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.ops import _build
from spintorque_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from spintorque_tpu_torch.physics.integrator import _plus_z_rows
from spintorque_tpu_torch.utils import profiling
from spintorque_tpu_torch.utils.profiling import (
    PROFILER,
    SPAN_NAMES,
    count_on_device,
    counter,
    device_trace,
    span,
    tracing,
    tracing_enabled,
)

ROOT = Path(__file__).resolve().parents[1]
ENV_SPANS = ("spin_torque.step", "spin_torque.decode", "integrator.pulse", "spin_torque.finish",
             "spin_torque.energy", "spin_torque.reward", "spin_torque.reset")

torch.set_num_threads(1)


def _env(batch=8, **kw):
    # 20 ps pulses at most: 100 substeps of the plain loop.
    return SpinTorqueEnv(batch_size=batch, config=SpinTorqueEnvConfig(max_duration=2e-11, **kw),
                         device="cpu")


def _actions(batch, steps):
    g = torch.Generator().manual_seed(3)
    current = torch.tensor([-2e6, -1e6, 0.0, 1e6, 2e6])[torch.randint(0, 5, (steps, batch),
                                                                       generator=g)]
    duration = 1e-12 + 1.9e-11 * torch.rand((steps, batch), generator=g)
    return torch.stack([current, duration], dim=-1)


def _new_spans(since):
    return PROFILER.spans()[since:]


def test_tracing_off_records_nothing():
    assert not tracing_enabled()
    assert span("spin_torque.step") is span("ppo.update")  # one shared no-op context
    env = _env()
    state, _ = env.reset(0)
    since, devices = len(PROFILER.spans()), PROFILER.device_counts()
    steps = counter("env.steps").count
    with span("ppo.update"):
        state, _ = env.step(state, _actions(8, 1)[0])
    assert _new_spans(since) == []
    assert PROFILER.device_counts() == devices
    assert counter("env.steps").count == steps + 1  # host counters count whatever the switch


def test_spans_nest_and_self_times_sum_to_the_root():
    since = len(PROFILER.spans())
    with tracing():
        assert tracing_enabled()
        with span("ppo.update"):
            with span("ppo.minibatch"):
                with span("ppo.forward"):
                    sum(range(20_000))
                sum(range(20_000))
            with span("ppo.metrics"):
                sum(range(20_000))
        with span("ppo.collect"):
            pass
    assert not tracing_enabled()
    recs = {r.name: r for r in _new_spans(since)}
    assert [r.name for r in _new_spans(since)] == ["ppo.forward", "ppo.minibatch", "ppo.metrics",
                                                     "ppo.update", "ppo.collect"]
    assert recs["ppo.update"].parent is None and recs["ppo.collect"].parent is None
    assert recs["ppo.forward"].parent == "ppo.minibatch"
    assert recs["ppo.minibatch"].parent == recs["ppo.metrics"].parent == "ppo.update"
    assert {recs[n].step for n in ("ppo.forward", "ppo.minibatch", "ppo.metrics")} == {
        recs["ppo.update"].step}
    assert recs["ppo.collect"].step == recs["ppo.update"].step + 1
    root = recs["ppo.update"]
    assert root.start_ns <= recs["ppo.forward"].start_ns <= recs["ppo.forward"].end_ns <= root.end_ns
    assert sum(recs[n].self_ns for n in ("ppo.update", "ppo.minibatch", "ppo.forward",
                                         "ppo.metrics")) == root.end_ns - root.start_ns
    mb = recs["ppo.minibatch"]
    assert mb.self_ns == (mb.end_ns - mb.start_ns) - (recs["ppo.forward"].end_ns
                                                       - recs["ppo.forward"].start_ns)
    stats = PROFILER.span_stats(2, since)
    assert stats["ppo.update"]["count"] == 0.5
    assert stats["ppo.update"]["total_ms"] == pytest.approx(
        (root.end_ns - root.start_ns) * 1e-6 / 2)


def test_counters_count_every_thread():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        name = "test.threads"
        start = counter(name).count

        def add(_):
            c = counter(name)  # registered once, whichever thread asks first
            for _ in range(2000):
                c.add()
            c.add(3)

        with ThreadPoolExecutor(16) as ex:
            list(ex.map(add, range(16)))
    finally:
        sys.setswitchinterval(switch)
    assert counter(name).count - start == 16 * 2003
    assert PROFILER.counters()[name] == counter(name).count


def test_spans_of_threads_nest_apart():
    since = len(PROFILER.spans())
    barrier = threading.Barrier(4)

    def run(_):
        with span("ppo.update"):
            barrier.wait(timeout=30)
            with span("ppo.gae"):
                pass

    with tracing(), ThreadPoolExecutor(4) as ex:
        list(ex.map(run, range(4)))
    recs = _new_spans(since)
    assert sorted(r.name for r in recs) == ["ppo.gae"] * 4 + ["ppo.update"] * 4
    assert all(r.parent == "ppo.update" for r in recs if r.name == "ppo.gae")
    assert len({r.thread for r in recs}) == 4


def test_a_span_lands_in_the_profiler_trace_as_a_user_annotation(tmp_path):
    assert not tracing_enabled()
    since = len(PROFILER.spans())
    with device_trace(str(tmp_path)) as prof:
        assert tracing_enabled()  # the trace turns the spans on
        with span("ppo.update"):
            with span("ppo.adam"):
                torch.ones(64).mul(2.0).sum()
    assert not tracing_enabled()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    notes = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"ppo.update", "ppo.adam"} <= set(notes)
    outer, inner = notes["ppo.update"], notes["ppo.adam"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mul"]
    assert ops and inner["ts"] <= ops[0]["ts"] <= inner["ts"] + inner["dur"]
    assert [r.name for r in _new_spans(since)] == ["ppo.adam", "ppo.update"]
    assert len(prof.key_averages()) > 0


def test_no_port_span_is_named_as_a_benchmark_span():
    tree = ast.parse((ROOT / "perfbench/lib/profile.py").read_text())
    bench = next(ast.literal_eval(n.value) for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", None) == "SPANS" for t in n.targets))
    assert bench and not set(bench) & set(SPAN_NAMES)
    assert len(set(SPAN_NAMES)) == len(SPAN_NAMES)
    assert all(re.fullmatch(r"[a-z_]+\.[a-z_]+", n) for n in SPAN_NAMES)


def test_env_step_records_each_span_once_a_step():
    env = _env()
    state, _ = env.reset(1)
    actions = _actions(8, 3)
    since, steps = len(PROFILER.spans()), counter("env.steps").count
    plus_z = PROFILER.device_counts().get("pulse.plus_z_rows", 0)
    with tracing():
        for a in actions:
            state, ts = env.step(state, a)
    recs = _new_spans(since)
    names = [r.name for r in recs]
    for name in ENV_SPANS:
        assert names.count(name) == 3, name
    assert names.count("spin_torque.observe") == 6  # the step's and the auto-reset's
    assert set(names) == set(ENV_SPANS) | {"spin_torque.observe"}
    parents = {(r.name, r.parent) for r in recs}
    assert parents == {("spin_torque.step", None), ("spin_torque.observe", "spin_torque.step"),
                       ("spin_torque.observe", "spin_torque.reset")} | {
        (n, "spin_torque.step") for n in ENV_SPANS[1:]}
    for step in {r.step for r in recs}:
        mine = [r for r in recs if r.step == step]
        root = next(r for r in mine if r.parent is None)
        assert sum(r.self_ns for r in mine) == root.end_ns - root.start_ns
    assert counter("env.steps").count == steps + 3
    counted = PROFILER.device_counts()["pulse.plus_z_rows"] - plus_z
    assert 0 <= counted <= 3 * 8


def test_ppo_update_records_sixteen_minibatches():
    trainer = PPOTrainer(_env(batch=8), PPOConfig())
    ts = trainer.init(0)
    ts, traj = trainer.collect(ts)
    since, minibatches = len(PROFILER.spans()), counter("ppo.minibatches").count
    reduces = counter("mesh.all_reduces").count
    with tracing():
        trainer.update(ts, traj)
    stats = PROFILER.span_stats(1, since)
    assert {k: v["count"] for k, v in stats.items()} == {
        "ppo.update": 1, "ppo.gae": 1, "ppo.normalize": 1, "ppo.minibatch": 16,
        "ppo.forward": 16, "ppo.backward": 16, "ppo.average_grads": 16, "ppo.clip": 16,
        "ppo.adam": 16, "ppo.metrics": 2}
    assert counter("ppo.minibatches").count == minibatches + 16
    assert counter("mesh.all_reduces").count == reduces  # no mesh: no collective
    parents = {r.name: r.parent for r in _new_spans(since)}
    assert parents["ppo.forward"] == parents["ppo.adam"] == "ppo.minibatch"
    assert parents["ppo.minibatch"] == parents["ppo.gae"] == "ppo.update"
    total = sum(v["self_ms"] for v in stats.values())
    assert total == pytest.approx(stats["ppo.update"]["total_ms"], rel=1e-9)


def test_collect_spans_nest_the_env_steps():
    trainer = PPOTrainer(_env(batch=8), PPOConfig(rollout_steps=2, hidden_sizes=(16, 16)))
    ts = trainer.init(0)
    since = len(PROFILER.spans())
    with tracing():
        trainer.collect(ts)
    recs = _new_spans(since)
    parents = {(r.name, r.parent) for r in recs}
    assert ("ppo.collect", None) in parents
    assert {("ppo.policy", "ppo.collect"), ("spin_torque.step", "ppo.collect")} <= parents
    assert [r.name for r in recs].count("ppo.policy") == 2


def _fake_build(monkeypatch, tmp_path):
    def fake_run(cmd):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return ""

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "_KERNEL_FNS", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    monkeypatch.setattr(_build, "_bind", lambda lib, optional=(): None)


def test_kernels_load_is_recorded_with_tracing_off(monkeypatch, tmp_path):
    _fake_build(monkeypatch, tmp_path)
    assert not tracing_enabled()
    since, builds = len(PROFILER.spans()), counter("kernels.builds").count
    _build.load_library()
    assert [r.name for r in _new_spans(since)] == ["kernels.load"]
    assert counter("kernels.builds").count == builds + 1
    # A second process finds the library on disk: a load, no build.
    monkeypatch.setattr(_build, "_LIBRARY", None)
    _build.load_library()
    assert [r.name for r in _new_spans(since)] == ["kernels.load"] * 2
    assert counter("kernels.builds").count == builds + 1


def _result(rows, plus_z):
    """A pulse result of ``rows`` rows, the first ``plus_z`` exactly +z."""
    m = torch.nn.functional.normalize(torch.rand((rows, 3)) + 0.1, dim=-1)
    m[:plus_z] = torch.tensor([0.0, 0.0, 1.0])
    m[plus_z:plus_z + 1] = torch.tensor([0.0, 1e-7, 1.0])  # near +z is not +z
    return tuple(m[:, c].contiguous() for c in range(3))


def test_a_device_count_is_counted_where_the_counts_are_read():
    calls = []

    def rows(mx, my, mz):
        calls.append(mx.numel())
        return _plus_z_rows(mx, my, mz)

    name = "test.kept_rows"
    with tracing():
        for n, z in ((5, 2), (1, 1), (7, 0)):
            count_on_device(name, rows, _result(n, z))
    assert calls == []  # nothing counted where the results were made
    assert PROFILER.device_counts()[name] == 3
    assert calls == [13]  # one count over the kept results' rows
    assert PROFILER.device_counts()[name] == 3 and calls == [13]


def test_a_device_count_counts_once_it_keeps_enough(monkeypatch):
    calls = []

    def rows(mx, my, mz):
        calls.append(mx.numel())
        return _plus_z_rows(mx, my, mz)

    monkeypatch.setattr(profiling, "KEEP_RESULTS", 3)
    monkeypatch.setattr(profiling, "KEEP_ROWS", 10)
    name = "test.kept_bound"
    for n, z in ((2, 1), (2, 2), (2, 0), (11, 4), (1, 1)):
        count_on_device(name, rows, _result(n, z))
    assert calls == [6, 11]  # three results, then eleven rows
    assert PROFILER.device_counts()[name] == 8
    assert calls == [6, 11, 1]


def test_env_step_keeps_its_pulses_for_the_plus_z_count_only_while_tracing():
    env = _env(batch=16, include_thermal=False)
    state, _ = env.reset(2)
    before = PROFILER.device_counts().get("pulse.plus_z_rows", 0)
    env.step(state, _actions(16, 1)[0])
    assert PROFILER.device_counts().get("pulse.plus_z_rows", 0) == before
    # A current of 0 leaves a row at +z exactly where it started there.
    m = torch.zeros((16, 3))
    m[:, 2] = 1.0
    m[5] = torch.tensor([0.6, 0.0, 0.8])
    action = torch.stack([torch.zeros(16), torch.full((16,), 1e-11)], dim=-1)
    with tracing():
        env.step(dataclasses.replace(state, m=m), action)
    assert PROFILER.device_counts()["pulse.plus_z_rows"] - before == 15
