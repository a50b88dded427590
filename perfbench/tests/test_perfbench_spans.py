"""``kernel_load_s``: read from the port's own span store after a run, and
nothing where the port recorded no such span or keeps no store."""

from __future__ import annotations

import sys
import types

import pytest
from conftest import TINY

from perfbench.lib import manifest, runner


def _reader():
    return manifest.load_module("metrics", "kernel_load_s").read


def test_kernel_load_s_sums_the_ports_kernels_load_spans(monkeypatch):
    from spintorque_tpu_torch.utils import profiling

    store = profiling.PerformanceProfiler()
    monkeypatch.setattr(profiling, "PROFILER", store)
    assert _reader()({}) is None
    rec = profiling.SpanRecord
    store.record_span(rec("kernels.load", None, 10, 2_500_000_010, 2_500_000_000, 0, 1))
    store.record_span(rec("spin_torque.step", None, 0, 10**9, 10**9, 1, 1))
    assert _reader()({}) == pytest.approx(2.5)


def test_kernel_load_s_reads_nothing_from_a_port_without_a_span_store(monkeypatch):
    older = types.ModuleType("spintorque_tpu_torch.utils.profiling")
    older.PerformanceProfiler = object  # the store of an older port: no PROFILER
    import spintorque_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "spintorque_tpu_torch.utils.profiling", older)
    monkeypatch.setattr(utils, "profiling", older)
    assert _reader()({}) is None


def test_a_cpu_run_loads_no_kernels_and_prints_no_kernel_load_s():
    out = runner.run_cell("gym-det-b1", 11, 0.2, True, device="cpu", overrides=TINY)
    assert "kernel_load_s" not in out["metrics"]
