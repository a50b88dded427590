"""The port's six examples (``examples/torch/``) on the CPU at a small size,
each through its ``main(argv)``, with the invariants of its result:

* quickstart_functional: finite mean reward, a success rate in [0, 1];
* quickstart_gymnasium: a finite return and an alignment in [-1, 1];
* optimize_pulse: a finite best objective after population x iterations
  evaluations;
* switching_diagram: every P(switch) in [0, 1], or NaN exactly where the
  whole ensemble failed (the diagram's '?'), and the record written where
  asked with None there;
* stiff_analysis: RK45 and Radau both succeed and agree within 1e-4
  (float32, rtol 1e-6, over 0.2 ns);
* train_ppo: the learning curve has one entry per logged update (every
  second and the last) and the curve file is written where asked.

Every example defaults to the card and raises where torch sees none unless
``--device cpu`` is given. The examples import no JAX
(``tests/test_torch_package.py::test_no_jax_import``).
"""

import importlib.util
import json
import math
import pathlib

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ("quickstart_functional", "quickstart_gymnasium", "train_ppo", "switching_diagram",
         "optimize_pulse", "stiff_analysis")


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_six_examples_are_there():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])


def test_quickstart_functional():
    out = _example("quickstart_functional").main(
        ["--device", "cpu", "--batch", "32", "--steps", "2", "--max-pulse", "2e-10"])
    assert math.isfinite(out["mean_reward"]) and 0.0 <= out["success_rate"] <= 1.0
    assert out["env_steps_per_s"] > 0 and out["where"] == "cpu"


def test_quickstart_gymnasium():
    out = _example("quickstart_gymnasium").main(["--device", "cpu", "--max-duration", "1e-10"])
    assert math.isfinite(out["return"]) and -1.0 <= out["alignment"] <= 1.0
    assert 1 <= out["steps"] <= 20


def test_optimize_pulse():
    out = _example("optimize_pulse").main(
        ["--device", "cpu", "--population", "16", "--elites", "4", "--iterations", "2"])
    assert math.isfinite(out["best_value"]) and out["n_evaluations"] == 32
    assert all(math.isfinite(v) for v in out["best_params"].values())


def test_switching_diagram(tmp_path):
    path = tmp_path / "build" / "switching_diagram.json"
    out = _example("switching_diagram").main(
        ["--device", "cpu", "--grid", "3", "--ensemble", "8", "--out", str(path)])
    assert out["trajectories"] == 72
    record = json.loads(path.read_text())
    for p_row, f_row, r_row in zip(out["p_switch"], out["failed_fraction"], record["p_switch"]):
        for p, f, r in zip(p_row, f_row, r_row):
            if math.isnan(p):
                assert f == 1.0 and r is None
            else:
                assert 0.0 <= p <= 1.0 and r == p


def test_stiff_analysis():
    out = _example("stiff_analysis").main(["--device", "cpu", "--batch", "4", "--span", "2e-10"])
    assert out["rk45"]["success"] and out["radau"]["success"]
    assert out["max_diff"] < 1e-4


def test_train_ppo(tmp_path):
    path = tmp_path / "curve.json"
    out = _example("train_ppo").main(
        ["--device", "cpu", "--updates", "3", "--batch", "32", "--out", str(path)])
    logged = [i for i in range(3) if i % 2 == 0 or i == 2]
    assert [c["update"] for c in out["curve"]] == logged
    assert out["summary"]["updates"] == 3
    assert json.loads(path.read_text())["curve"] == out["curve"]
