"""The array env of the system under test: ``SpinTorqueArrayEnv`` of
``spintorque_tpu_torch.envs.array`` (SpinTorqueArray-v0), its spans and
its counters. The one module of the benchmark that imports the array env;
beside ``program.py`` and ``program_spans.py`` the only one that imports
the port.

A port that records no array span or counter (one older than them) reads
as None there: a metric read from it is then left out of the result line.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np
import torch

# The port's names that the benchmark reads.
STEP, SWEEP = "array.step", "array.sweep"
DEVICE_UPDATES = "array.device_updates"


def make_env(config: Dict, batch: int, device, *, control: bool = False):
    """The port's ``SpinTorqueArrayEnv`` for a configuration file, with its
    device parameters and target pattern handed to it. ``control`` runs
    the env in bfloat16, the precision below the configuration's float32."""
    from spintorque_tpu_torch.envs.array import ArrayEnvConfig, SpinTorqueArrayEnv

    env_cfg = dict(config["env"])
    if control:
        env_cfg["dtype"] = "bfloat16"
    params = {k: (np.asarray(v) if isinstance(v, list) else v)
              for k, v in config["device_params"].items()}
    return SpinTorqueArrayEnv(device_params=params,
                              target_pattern=np.asarray(config["target_pattern"], float),
                              batch_size=batch, config=ArrayEnvConfig(**env_cfg), device=device)


def tracing():
    """The port's tracing switch for the block (``profiling.tracing``)."""
    from spintorque_tpu_torch.utils import profiling

    return profiling.tracing()


def _store():
    """The port's span and counter store."""
    from spintorque_tpu_torch.utils import profiling

    return profiling.PROFILER


def span_count() -> int:
    """How many spans the port's store holds so far."""
    return len(_store().spans())


def step_spans(since: int) -> Optional[Dict[str, float]]:
    """Of the spans recorded after the first ``since``: the number of
    ``array.step`` spans, and the seconds in them and in ``array.sweep``;
    None where the port recorded no ``array.step``."""
    by_name = _store().span_stats(1, since)
    if STEP not in by_name:
        return None
    return dict(steps=int(by_name[STEP]["count"]), step_s=by_name[STEP]["total_ms"] * 1e-3,
                sweep_s=by_name.get(SWEEP, {"total_ms": 0.0})["total_ms"] * 1e-3)


def device_updates() -> Optional[int]:
    """The port's ``array.device_updates`` counter, or None where it has
    none."""
    return _store().counters().get(DEVICE_UPDATES)


def _half_sweep(sweep):
    """Sweeps the first half of the arrays and leaves the rest as they were,
    with no energy."""
    def half(pattern, mask, current, duration):
        h = max(pattern.shape[0] // 2, 1)
        out, energy = sweep(pattern[:h], mask[:h], current[:h], duration[:h])
        return (torch.cat([out, pattern[h:]]),
                torch.cat([energy, torch.zeros_like(current[h:])]))
    return half


def _altered_sweep(sweep):
    """Moves device 0 of array 0 by 0.05 in m_x after the sweep."""
    def altered(*args):
        out, energy = sweep(*args)
        out = out.clone()
        out[0, 0, 0] += 0.05
        return out, energy
    return altered


FAULTS = {"half": _half_sweep, "altered": _altered_sweep}


def carry_fault(env) -> None:
    """``lib/faults.py`` plants ``half`` and ``altered`` in the pulse of
    ``SpinTorqueEnv``, which the array env never calls; where one of them
    is planted (the module's ``integrate_pulse`` is its wrapper, named after
    the fault), the same fault goes into this env's sweeps."""
    module = sys.modules.get("spintorque_tpu_torch.envs.spin_torque")
    name = getattr(getattr(module, "integrate_pulse", None), "__name__", None)
    if name in FAULTS:
        for attr in ("_sequential_sweep", "_simultaneous_sweep"):
            setattr(env, attr, FAULTS[name](getattr(env, attr)))
