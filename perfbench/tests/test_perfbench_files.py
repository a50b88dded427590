"""The manifest and the files it names: each found by name, and a new cell
added as new files only."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, TINY

from perfbench.lib import manifest

BENCH = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_has_exactly_its_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    entry = manifest.cell_entry(BENCH, cell)
    wl = manifest.workload(cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    config = manifest.config(entry["config"])
    assert config["name"] == entry["config"] and config["reduced"] == []
    assert hasattr(manifest.load_module("drivers", wl["driver"]), "run")
    assert "state_err" in wl["check"]["limits"]
    e2e = [m["name"] for m in manifest.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics_for(BENCH, cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_readers_are_found_by_name(metric):
    assert callable(manifest.load_module("metrics", metric).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_its_own(config):
    path = ROOT / config["file"]
    assert path.parent == ROOT / "perfbench" / "configs"
    assert json.loads(path.read_text())["source"] == config["source"]
    assert sum(c["file"] == config["file"] for c in BENCH["configs"]) == 1


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_only(tmp_path):
    """Copies the benchmark, adds a cell as one workload file and entries in
    the manifest, and runs it on the CPU: no file of the copy's perfbench/
    changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    wl = json.loads((tmp_path / "perfbench/workloads/gym-det-b1.json").read_text())
    wl.update(name="gym-thermal-b1", config="spintorque-v0-thermal")
    (tmp_path / "perfbench/workloads/gym-thermal-b1.json").write_text(json.dumps(wl))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "gym-thermal-b1", "config": "spintorque-v0-thermal",
                               "traffic": "gym-levels-b1", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gym-det-b1" in m.get("workloads", []):
            m["workloads"].append("gym-thermal-b1")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from perfbench.lib import runner, manifest\n"
            f"assert str(manifest.ROOT) == {str(tmp_path)!r}\n"
            f"out = runner.run_cell('gym-thermal-b1', 5, 0.2, True, device='cpu', "
            f"overrides={TINY!r})\n"
            "print(json.dumps([out['correct'], sorted(out['metrics'])]))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    correct, metrics = json.loads(res.stdout.strip().splitlines()[-1])
    # The CPU has no device trace: the idle share reads nothing there.
    assert correct and metrics == ["step_host_ms.gym"]
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ but no program: the
    run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}]\n"
            "from perfbench.lib import runner\n"
            "runner.run_cell('gym-det-b1', 5, 0.2, False, device='cpu')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""
    assert "spintorque_tpu_torch" in res.stderr
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gym-det-b1",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.parametrize("source", ["host", "card"])
def test_traffic_draws_every_level_and_repeats_by_seed(source):
    """Each env cell's currents come from its listed levels, every level
    drawn; durations lie in their range; a seed repeats its actions."""
    import numpy as np
    import torch

    from perfbench.lib.traffic import Actions

    device = torch.device("cpu")
    for cell in ("rollout-thermal-b4096", "gym-det-b1"):
        traffic = dict(manifest.workload(cell)["traffic"], source=source)
        a = np.asarray(Actions(traffic, 4096, 2**40 + 3, device)())
        assert a.shape == (4096, 2) and a.dtype == np.float32
        assert set(a[:, 0].tolist()) == set(np.float32(traffic["current_levels"]).tolist())
        lo, hi = traffic["duration"]
        assert np.all((a[:, 1] >= np.float32(lo)) & (a[:, 1] <= np.float32(hi)))
        assert np.array_equal(a, np.asarray(Actions(traffic, 4096, 2**40 + 3, device)()))
