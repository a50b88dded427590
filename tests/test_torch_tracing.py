"""The port's tracing facility (``spintorque_tpu_torch.utils.profiling``):
spans, counters and the profiler's annotations, and the spans of the env
step and the PPO update on the CPU.

Every test takes deltas of the process-wide store (``PROFILER``), which
the other tests of a worker share, and leaves the switch as it found it.
"""

from __future__ import annotations

import ast
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
from spintorque_tpu_torch.utils.profiling import (
    PROFILER,
    SPAN_NAMES,
    counter,
    device_trace,
    span,
    tracing,
    tracing_enabled,
)

ROOT = Path(__file__).resolve().parents[1]
ENV_SPANS = ("spin_torque.step", "integrator.pulse")

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
    since = len(PROFILER.spans())
    steps = counter("env.steps").count
    with span("ppo.update"):
        state, _ = env.step(state, _actions(8, 1)[0])
    assert _new_spans(since) == []
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
    with tracing():
        for a in actions:
            state, ts = env.step(state, a)
    recs = _new_spans(since)
    names = [r.name for r in recs]
    for name in ENV_SPANS:
        assert names.count(name) == 3, name
    assert set(names) == set(ENV_SPANS)
    parents = {(r.name, r.parent) for r in recs}
    assert parents == {("spin_torque.step", None), ("integrator.pulse", "spin_torque.step")}
    for step in {r.step for r in recs}:
        mine = [r for r in recs if r.step == step]
        root = next(r for r in mine if r.parent is None)
        assert sum(r.self_ns for r in mine) == root.end_ns - root.start_ns
    assert counter("env.steps").count == steps + 3


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
