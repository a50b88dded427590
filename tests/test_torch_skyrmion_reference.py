"""The benchmark's plain reference of a racetrack step
(``perfbench/reference/racetrack.py``) against the port's CPU step, and its
check (``perfbench/drivers/racetrack.py``) against a port step that leaves
a force out.

The reference follows upstream's description in float32 in the port's op
order, so on one device it gives the port's bits: over 300 steps at B=64
(two auto-resets of every track) in both action modes every check number
reads 0. A port step without the thermal kick, or without the pinning
wells, moves the fresh undriven tracks' small velocities, and the check
reads ``correct`` false. The reference imports neither JAX nor the port.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import manifest, racetrack_program  # noqa: E402
from perfbench.lib.check import Sample  # noqa: E402
from perfbench.lib.traffic import ENV_STREAM, subseed  # noqa: E402

torch.set_num_threads(1)

CELL = "racetrack-b4096"
CONFIG = manifest.config("skyrmion-racetrack-v0")
LIMITS = manifest.workload(CELL)["check"]["limits"]
BATCH, STEPS = 64, 300
CPU = torch.device("cpu")


def _driver():
    return manifest.load_module("drivers", "racetrack")


def _config(mode):
    return dict(CONFIG, env=dict(CONFIG["env"], action_mode=mode))


def _actions(mode, seed):
    """The cell's Discrete(45) draws, or Box actions with a current on half
    the tracks (the others moved by the kick, the wells and the gradient)."""
    if mode == "discrete":
        draw = _driver().Actions({"actions": [0, 44]}, BATCH, seed, CPU)
        return [draw() for _ in range(STEPS)]
    rng = np.random.default_rng(seed)
    j = rng.uniform(-1e12, 1e12, (STEPS, BATCH, 2)) * (rng.random((STEPS, BATCH, 1)) < 0.5)
    return torch.as_tensor(np.concatenate([j, rng.uniform(-1e18, 1e18, (STEPS, BATCH, 2)),
                                           rng.uniform(0.0, 2e-9, (STEPS, BATCH, 1))], -1))


def _run(mode, seed, patch=None):
    """STEPS steps of the port's CPU env from its reset, every one kept as a
    sample, and the check's numbers over them."""
    config = _config(mode)
    env = racetrack_program.make_env(config, BATCH, CPU, _driver().pin_seed(seed))
    if patch is not None:
        patch(env)
    state, _ = env.reset(subseed(seed, ENV_STREAM))
    start, samples, resets, fresh = state, [], 0, 0
    for action in _actions(mode, seed):
        nxt, ts = env.step(state, action)
        samples.append(Sample(state, action, nxt, ts))
        resets += int((ts.terminated | ts.truncated).sum())
        # Tracks at rest a step ago that moved by less than 1 m/s: only the
        # kick, the wells and the gradient drove them.
        rest = (state.velocities == 0).all(-1).all(-1)
        fresh += int((rest & (nxt.velocities.abs() < 1.0).all(-1).all(-1)).sum())
        state = nxt
    return _driver().compare(config, seed, BATCH, start, samples), resets, fresh


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_the_reference_gives_the_port_cpu_steps_bits(mode):
    out, resets, fresh = _run(mode, 2**40 + 17)
    assert out["steps"] == STEPS and out["rows"] == STEPS * BATCH
    assert out["numbers"] == dict.fromkeys(LIMITS, 0.0)
    assert resets >= 2 * BATCH  # every track truncated at steps 150 and 300
    assert fresh > 0


def _no_kick(env):
    env.config = env.config._replace(include_thermal=False)


def _no_pinning(env):
    env.config = env.config._replace(include_pinning=False)


@pytest.mark.parametrize("patch", [_no_kick, _no_pinning], ids=["kick", "pinning"])
def test_the_check_sees_a_force_left_out_of_the_port_step(patch):
    out, _, fresh = _run("discrete", 2**41 + 3, patch)
    assert fresh > 0
    assert out["numbers"]["velocity_err"] > LIMITS["velocity_err"]
    assert any(out["numbers"][k] > LIMITS[k] for k in LIMITS)


def test_the_reference_imports_neither_jax_nor_the_port():
    tree = ast.parse((ROOT / "perfbench/reference/racetrack.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "math", "typing", "numpy", "torch",
                     "perfbench.reference"}
