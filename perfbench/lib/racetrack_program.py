"""The racetrack env of the system under test: ``SkyrmionRacetrackEnv`` of
``spintorque_tpu_torch.envs.skyrmion`` (SkyrmionRacetrack-v0), its spans and
its counters. The one module of the benchmark that imports the racetrack
env; beside ``program.py``, ``program_spans.py`` and ``array_program.py``
(whose tracing switch and span store it shares) the only one that imports
the port.

A port that records no racetrack span or counter (one older than them)
reads as None there: a metric read from it is then left out of the result
line.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import torch

from perfbench.lib.array_program import _store, span_count, tracing  # noqa: F401

# The port's names that the benchmark reads.
STEP = "racetrack.step"
REPLAYS, STEPS = "racetrack.graph_replays", "racetrack.steps"


def make_env(config: Dict, batch: int, device, pin_seed: int, *, control: bool = False):
    """The port's ``SkyrmionRacetrackEnv`` for a configuration file, its
    pinning sites drawn from ``pin_seed`` and its targets handed to it.
    Keys of the ``env`` block that the racetrack's configuration does not
    have (another env's, such as a test's pulse length) are left out.
    ``control`` runs the env in bfloat16, the precision below the
    configuration's float32."""
    from spintorque_tpu_torch.envs.skyrmion import SkyrmionEnvConfig, SkyrmionRacetrackEnv

    env_cfg = {k: v for k, v in config["env"].items() if k in SkyrmionEnvConfig._fields}
    if control:
        env_cfg["dtype"] = "bfloat16"
    return SkyrmionRacetrackEnv(target_positions=list(config["target_positions"]),
                                batch_size=batch, config=SkyrmionEnvConfig(**env_cfg),
                                seed=pin_seed, device=device)


def step_spans(since: int) -> Optional[Dict[str, float]]:
    """Of the spans recorded after the first ``since``: the number of
    ``racetrack.step`` spans and the seconds in them; None where the port
    recorded no ``racetrack.step``."""
    by_name = _store().span_stats(1, since)
    if STEP not in by_name:
        return None
    return dict(steps=int(by_name[STEP]["count"]), step_s=by_name[STEP]["total_ms"] * 1e-3)


def replay_share() -> Optional[float]:
    """The port's ``racetrack.graph_replays`` over its ``racetrack.steps``,
    so far in this process; None where it has neither counter or counted no
    step."""
    counts = _store().counters()
    if REPLAYS not in counts or STEPS not in counts or not counts[STEPS]:
        return None
    return counts[REPLAYS] / counts[STEPS]


def _half_substeps(substeps):
    """Moves the first half of the tracks and leaves the rest as they
    were."""
    def half(pos, vel, force, dur):
        h = max(pos.shape[0] // 2, 1)
        p, v = substeps(pos[:h], vel[:h], force[:h], dur[:h])
        return torch.cat([p, pos[h:]]), torch.cat([v, vel[h:]])
    return half


def _altered_substeps(substeps):
    """Moves skyrmion 0 of track 0 by 5% in x after the substeps."""
    def altered(*args):
        p, v = substeps(*args)
        p = p.clone()
        p[0, 0, 0] *= 1.05
        return p, v
    return altered


FAULTS = {"half": _half_substeps, "altered": _altered_substeps}


def carry_fault(env) -> None:
    """``lib/faults.py`` plants ``half`` and ``altered`` in the pulse of
    ``SpinTorqueEnv``, which the racetrack never calls; where one of them is
    planted (the module's ``integrate_pulse`` is its wrapper, named after
    the fault), the same fault goes into this env's substeps."""
    module = sys.modules.get("spintorque_tpu_torch.envs.spin_torque")
    name = getattr(getattr(module, "integrate_pulse", None), "__name__", None)
    if name in FAULTS:
        env._substeps = FAULTS[name](env._substeps)

