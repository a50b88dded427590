"""The array cell (``array-4x4``, SpinTorqueArray-v0): the plain reference
against the port's CPU step bit for bit, a sound run, the bf16 control and
three faults planted in the port's array env, each read by the check, the
traffic, and the per-layer metrics' readers. The card's cases carry the
``cuda`` marker."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from conftest import TINY

from perfbench.lib import array_program, manifest, runner
from perfbench.reference import array as ref

CELL = "array-4x4"
CONFIG = manifest.config("spintorque-array-v0")


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _driver():
    return manifest.load_module("drivers", "array")


def _config(**env):
    return dict(CONFIG, env=dict(CONFIG["env"], **env))


def _actions(batch, seed, device="cpu"):
    traffic = manifest.workload(CELL)["traffic"]
    return _driver().Actions(traffic, 16, batch, seed, torch.device(device))


def test_reference_equals_the_port_cpu_step_bit_for_bit():
    """24 steps of B=8 arrays with max_steps 6, so every array resets at
    least three times (and some on success): each step's pattern after the
    sweep, observation, reward, flags and next state, and the reset."""
    config = _config(max_steps=6)
    batch, seed, cpu = 8, 2**40 + 7, torch.device("cpu")
    env = array_program.make_env(config, batch, cpu)
    renv = ref.make_env(config, cpu)
    state, _ = env.reset(seed)
    want = ref.reset(renv, seed, batch, cpu)
    for f in ref.State._fields:
        assert _bits_equal(getattr(state, f), getattr(want, f)), f
    actions = _actions(batch, seed)
    resets, moved = 0, False
    for _ in range(24):
        action = actions()
        nxt, ts = env.step(state, action)
        out = ref.step(renv, ref.State(*(getattr(state, f) for f in ref.State._fields)), action,
                       state.seed, state.counter)
        pattern = ts.info["final_observation"][..., :3].reshape(out.pattern.shape)
        assert _bits_equal(pattern, out.pattern)
        assert _bits_equal(ts.obs, out.obs)
        assert _bits_equal(ts.reward, out.reward)
        assert torch.equal(ts.terminated, out.terminated)
        assert torch.equal(ts.truncated, out.truncated)
        for f in ref.State._fields:
            assert _bits_equal(getattr(nxt, f), getattr(out.next_state, f)), f
        assert nxt.counter == state.counter + 1
        resets += int((ts.terminated | ts.truncated).sum())
        moved = moved or not torch.equal(out.pattern, state.pattern)
        state = nxt
    assert resets >= 3 * batch
    # The sweep moved the pulsed devices: the comparison sees real dynamics.
    assert moved


def test_coupling_matrix_is_the_ports():
    from spintorque_tpu_torch.envs.array import ArrayEnvConfig, coupling_matrix

    e = CONFIG["env"]
    want = coupling_matrix(ArrayEnvConfig(rows=e["rows"], cols=e["cols"],
                                          coupling_strength=e["coupling_strength"]))
    assert np.array_equal(ref.coupling_matrix(e["rows"], e["cols"], e["coupling_strength"]),
                          want)


def test_actions_draw_every_device_and_repeat_by_seed():
    a = _actions(4096, 2**40 + 3)()
    assert a.shape == (4096, 3) and a.dtype == torch.float32
    assert sorted(set(a[:, 0].tolist())) == [float(i) for i in range(16)]
    assert bool((a[:, 1].abs() <= 2e6).all()) and float(a[:, 1].min()) < -1.9e6
    assert bool(((a[:, 2] >= np.float32(1e-12)) & (a[:, 2] <= np.float32(5e-9))).all())
    assert torch.equal(a, _actions(4096, 2**40 + 3)())


def _run(trace=False, **kw):
    return runner.run_cell(CELL, 2**33 + 5, 0.3, trace, device="cpu", overrides=TINY, **kw)


def test_sound_tiny_run_is_correct_and_reads_the_spans():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert out["records"]["window"]["steps"] >= 2
    # The CPU has no device trace: only the port's spans read.
    assert sorted(out["metrics"]) == ["glue_ms.array", "sweep_ms.array"]
    assert 0.0 < out["metrics"]["sweep_ms.array"]["value"]
    assert out["records"]["trace"]["device_updates"] == 16 * out["records"]["trace"]["steps"]


def test_control_bfloat16_is_not_correct():
    out = _run(control=True)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _unchanged(step):
    def unchanged(self, state, action, mesh=None):
        return state, step(self, state, action)[1]
    return unchanged


def _half(sweep):
    def half(self, pattern, mask, current, duration):
        h = pattern.shape[0] // 2
        out, energy = sweep(self, pattern[:h], mask[:h], current[:h], duration[:h])
        return torch.cat([out, pattern[h:]]), torch.cat([energy, torch.zeros_like(current[h:])])
    return half


def _altered(sweep):
    def altered(self, *args):
        out, energy = sweep(self, *args)
        out = out.clone()
        out[:, 0, 0] += 0.05
        return out, energy
    return altered


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_planted_in_the_array_env_is_not_correct(monkeypatch, fault):
    from spintorque_tpu_torch.envs.array import SpinTorqueArrayEnv as Env

    if fault == "unchanged":
        monkeypatch.setattr(Env, "step", _unchanged(Env.step))
    else:
        wrap = _half if fault == "half" else _altered
        monkeypatch.setattr(Env, "_sequential_sweep", wrap(Env._sequential_sweep))
    out = _run()
    assert not out["correct"], out["checks"]


def test_metrics_read_nothing_from_a_port_without_array_spans(monkeypatch):
    from spintorque_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "PROFILER", profiling.PerformanceProfiler())
    assert array_program.step_spans(0) is None
    assert array_program.device_updates() is None
    records = {"window": {"seconds": 1.0, "steps": 4}, "array_spans": None, "trace": None}
    for name in ("sweep_ms.array", "glue_ms.array", "device_kernels.array",
                 "device_idle_pct.array"):
        assert manifest.load_module("metrics", name).read(records) is None


def test_step_spans_sum_the_roots_and_the_sweeps(monkeypatch):
    from spintorque_tpu_torch.utils import profiling

    store = profiling.PerformanceProfiler()
    monkeypatch.setattr(profiling, "PROFILER", store)
    rec = profiling.SpanRecord
    store.record_span(rec("spin_torque.step", None, 0, 10**9, 10**9, 0, 1))
    for k in range(2):
        t = 10**9 * (k + 1)
        store.record_span(rec("array.sweep", "array.step", t, t + 3 * 10**6, 3 * 10**6, k, 1))
        store.record_span(rec("array.step", None, t, t + 5 * 10**6, 2 * 10**6, k, 1))
    spans = array_program.step_spans(1)
    assert spans["steps"] == 2
    records = {"array_spans": spans}
    assert manifest.load_module("metrics", "sweep_ms.array").read(records) == pytest.approx(3.0)
    assert manifest.load_module("metrics", "glue_ms.array").read(records) == pytest.approx(2.0)


@pytest.mark.cuda
def test_reference_equals_the_port_step_on_the_card(card):
    """Eight steps at the cell's batch on the card, max_steps 4 so that the
    auto-reset runs: the same ops in the same order give the same bits."""
    config = _config(max_steps=4)
    batch, seed = manifest.workload(CELL)["batch"], 2**41 + 3
    env = array_program.make_env(config, batch, card)
    renv = ref.make_env(config, card)
    state, _ = env.reset(seed)
    actions = _actions(batch, seed, card)
    for _ in range(8):
        action = actions()
        nxt, ts = env.step(state, action)
        out = ref.step(renv, ref.State(*(getattr(state, f) for f in ref.State._fields)), action,
                       state.seed, state.counter)
        assert _bits_equal(ts.obs, out.obs)
        assert _bits_equal(ts.reward, out.reward)
        for f in ref.State._fields:
            assert _bits_equal(getattr(nxt, f), getattr(out.next_state, f)), f
        state = nxt


def test_the_array_state_fields_are_the_port_state_fields():
    from spintorque_tpu_torch.envs.array import ArrayEnvState

    assert set(ref.State._fields) <= {f.name for f in dataclasses.fields(ArrayEnvState)}
