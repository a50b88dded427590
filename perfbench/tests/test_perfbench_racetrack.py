"""The racetrack cell (``racetrack-b4096``, SkyrmionRacetrack-v0): the plain
reference against the port's CPU step bit for bit, a sound run, faults
planted in the port's racetrack env, each read by the check, the traffic,
the check's per-entry comparison, and the per-layer metrics' readers. The
card's cases carry the ``cuda`` marker."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import TINY

from perfbench.lib import manifest, racetrack_program, runner
from perfbench.reference import racetrack as ref

CELL = "racetrack-b4096"
CONFIG = manifest.config("skyrmion-racetrack-v0")


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _driver():
    return manifest.load_module("drivers", "racetrack")


def _config(**env):
    return dict(CONFIG, env=dict(CONFIG["env"], **env))


def _actions(batch, seed, steps, device="cpu"):
    """The cell's draws for ``steps`` steps, one a step."""
    traffic = manifest.workload(CELL)["traffic"]
    draw = _driver().Actions(traffic, batch, seed, torch.device(device))
    return [draw() for _ in range(steps)]


def _step_bits(env, renv, state, action):
    """One step of the port and of the reference from ``state``: each
    output bit for bit."""
    nxt, ts = env.step(state, action)
    out = ref.step(renv, ref.State(*(getattr(state, f) for f in ref.State._fields)), action,
                   state.seed, state.counter)
    assert _bits_equal(ts.info["final_observation"], out.final_obs)
    assert _bits_equal(ts.obs, out.obs)
    assert _bits_equal(ts.reward, out.reward)
    assert torch.equal(ts.terminated, out.terminated)
    assert torch.equal(ts.truncated, out.truncated)
    for f in ref.State._fields:
        assert _bits_equal(getattr(nxt, f), getattr(out.next_state, f)), f
    assert nxt.counter == state.counter + 1
    return nxt, ts


def test_reference_equals_the_port_cpu_step_bit_for_bit():
    """24 steps of B=8 tracks with max_steps 6, so every track resets at
    least three times: each step's observations, reward, flags and next
    state, and the reset."""
    config = _config(max_steps=6)
    batch, seed, cpu = 8, 2**40 + 7, torch.device("cpu")
    env = racetrack_program.make_env(config, batch, cpu, 11)
    renv = ref.make_env(config, 11, cpu)
    assert _bits_equal(env.pin_x, renv.pin_x) and _bits_equal(env.pin_strength,
                                                              renv.pin_strength)
    state, _ = env.reset(seed)
    want = ref.reset(renv, seed, batch, cpu)
    for f in ref.State._fields:
        assert _bits_equal(getattr(state, f), getattr(want, f)), f
    resets = 0
    for action in _actions(batch, seed, 24):
        nxt, ts = _step_bits(env, renv, state, action)
        resets += int((ts.terminated | ts.truncated).sum())
        state = nxt
    assert resets >= 3 * batch


def test_actions_draw_every_index_and_repeat_by_seed():
    a = torch.stack(_actions(4096, 2**40 + 3, 16))
    assert a.shape == (16, 4096) and a.dtype == torch.int64
    assert sorted(set(a[0].tolist())) == list(range(45))
    assert not torch.equal(a[0], a[1])
    assert torch.equal(a, torch.stack(_actions(4096, 2**40 + 3, 16)))
    with pytest.raises(ValueError, match="Discrete"):
        _driver().Actions({"actions": [0, 45]}, 8, 1, torch.device("cpu"))


def test_relative_reads_each_entry_against_its_own_scale():
    relative = _driver().relative
    want = torch.tensor([1e-4, 3e8, 0.0, float("nan")])
    assert relative(want.clone(), want) == 0.0
    moved = want + torch.tensor([1e-7, 0.0, 0.0, 0.0])
    assert relative(moved, want) == pytest.approx(1e-3, rel=1e-4)
    # A move of 1 m/s on a driven track is nothing against its 3e8.
    assert relative(want + torch.tensor([0.0, 1.0, 0.0, 0.0]), want) < 1e-8
    assert relative(torch.tensor([0.0, 0.0, 1e-30, 0.0]), torch.zeros(4)) > 1e300
    assert relative(torch.tensor([1.0]), torch.tensor([float("nan")])) > 1e300


def test_a_kept_step_copied_to_the_host_keeps_its_bits():
    from perfbench.lib.check import Sample

    env = racetrack_program.make_env(CONFIG, 8, torch.device("cpu"), 3)
    state, _ = env.reset(4)
    action = _actions(8, 4, 1)[0]
    nxt, ts = env.step(state, action)
    got = _driver().to_host([Sample(state, action, nxt, ts)])[0]
    assert type(got.state) is type(state) and type(got.ts) is type(ts)
    assert (got.state.seed, got.state_out.counter) == (state.seed, nxt.counter)
    assert _bits_equal(got.ts.info["final_observation"], ts.info["final_observation"])
    for f in ref.State._fields:
        assert _bits_equal(getattr(got.state_out, f), getattr(nxt, f)), f


def _run(trace=False, **kw):
    return runner.run_cell(CELL, 2**33 + 5, 0.3, trace, device="cpu", overrides=TINY, **kw)


def test_sound_tiny_run_is_correct_and_reads_the_spans():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert out["records"]["window"]["steps"] >= 2
    # The CPU has no device trace and replays nothing: only the port's span reads.
    assert sorted(out["metrics"]) == ["step_host_ms.racetrack"]
    assert 0.0 < out["metrics"]["step_host_ms.racetrack"]["value"]


def _unchanged(step):
    def unchanged(self, state, action, mesh=None):
        return state, step(self, state, action)[1]
    return unchanged


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_planted_in_the_racetrack_env_is_not_correct(monkeypatch, fault):
    from spintorque_tpu_torch.envs.skyrmion import SkyrmionRacetrackEnv as Env

    if fault == "unchanged":
        monkeypatch.setattr(Env, "step", _unchanged(Env.step))
    else:
        wrap = racetrack_program.FAULTS[fault]
        substeps = Env._substeps
        monkeypatch.setattr(Env, "_substeps",
                            lambda self, *a: wrap(lambda *b: substeps(self, *b))(*a))
    out = _run()
    assert not out["correct"], out["checks"]


def test_metrics_read_nothing_from_a_port_without_racetrack_spans(monkeypatch):
    from spintorque_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "PROFILER", profiling.PerformanceProfiler())
    assert racetrack_program.step_spans(0) is None
    assert racetrack_program.replay_share() is None
    records = {"window": {"seconds": 1.0, "steps": 4}, "racetrack_spans": None, "trace": None}
    for name in ("step_host_ms.racetrack", "device_kernels.racetrack",
                 "device_idle_pct.racetrack", "replay_share.racetrack"):
        assert manifest.load_module("metrics", name).read(records) is None


def test_step_spans_and_the_replay_share_read_the_ports_store(monkeypatch):
    from spintorque_tpu_torch.utils import profiling

    store = profiling.PerformanceProfiler()
    monkeypatch.setattr(profiling, "PROFILER", store)
    rec = profiling.SpanRecord
    store.record_span(rec("array.step", None, 0, 10**9, 10**9, 0, 1))
    for k in range(2):
        t = 10**9 * (k + 1)
        store.record_span(rec("racetrack.replay", "racetrack.step", t, t + 10**6, 10**6, k, 1))
        store.record_span(rec("racetrack.step", None, t, t + 3 * 10**6, 2 * 10**6, k, 1))
    spans = racetrack_program.step_spans(1)
    assert spans["steps"] == 2
    read = manifest.load_module("metrics", "step_host_ms.racetrack").read
    assert read({"racetrack_spans": spans}) == pytest.approx(3.0)
    monkeypatch.setattr(store, "counters",
                        lambda: {"racetrack.graph_replays": 99, "racetrack.steps": 100})
    assert racetrack_program.replay_share() == pytest.approx(0.99)


def test_the_racetrack_state_fields_are_the_port_state_fields():
    from spintorque_tpu_torch.envs.skyrmion import SkyrmionEnvState

    assert set(ref.State._fields) <= {f.name for f in dataclasses.fields(SkyrmionEnvState)}


@pytest.mark.cuda
def test_reference_equals_the_port_step_on_the_card(card):
    """Eight steps at the cell's batch on the card, max_steps 4 so that the
    auto-reset runs: the same ops in the same order give the same bits,
    the port's step a graph's replay after its first."""
    config = _config(max_steps=4)
    batch, seed = manifest.workload(CELL)["batch"], 2**41 + 3
    env = racetrack_program.make_env(config, batch, card, 5)
    renv = ref.make_env(config, 5, card)
    state, _ = env.reset(seed)
    for action in _actions(batch, seed, 8, card):
        state, _ = _step_bits(env, renv, state, action)
    assert racetrack_program.replay_share() > 0.0
