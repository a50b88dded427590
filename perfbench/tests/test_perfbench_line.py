"""The result line's keys, and a run without a card."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys

from conftest import ROOT, TINY

from perfbench.lib import runner


def _run_module():
    spec = importlib.util.spec_from_file_location("perfbench_run", ROOT / "perfbench/run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_last_line_has_exactly_its_keys():
    run = _run_module()
    for trace in (False, True):
        out = runner.run_cell("rollout-thermal-b4096", 9, 0.2, trace, device="cpu",
                              overrides=TINY)
        line = json.loads(json.dumps(run.result_line(out, "a card")))
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
        assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
            {"busy_s", "window_s"} if trace else set())
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        if trace:
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gym-det-b1",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 3 and res.stdout == ""
    assert "needs 1 CUDA card" in res.stderr
