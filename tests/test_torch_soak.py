"""The soak program (``spintorque_tpu_torch.utils.soak``, the counterpart of
``scripts/soak_test.py``) on the CPU at a tiny size: B=32, pulses of at
most 0.1 ns, 2 blocks of 16 steps.

* Thermal off, the run is healthy: no bad block, no failed solve,
  episodes turning over.
* Thermal on at that pulse length, 10.6% of solves fail in both packages
  (the reference noise mode blows up RK4 on the shortest pulses; at the
  default 5 ns the JAX record has 3.46%), so the run is unhealthy with no
  bad block: the failed-fraction check is not vacuous.
* A state poisoned with a NaN (every env's total energy, which the vector
  observation carries) gives bad blocks and ``healthy: false``: the
  invariant check is not vacuous either. (A NaN magnetization would not
  do: the pulse renormalizes it to +z.)
* ``main`` writes its record and exits 1 when the run is unhealthy.
"""

import dataclasses
import json

import torch

from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.utils import soak as soak_mod
from spintorque_tpu_torch.utils.soak import N_INNER, soak

torch.set_num_threads(1)

B = 32


def _env(**kw):
    return SpinTorqueEnv(batch_size=B, config=SpinTorqueEnvConfig(max_duration=1e-10, **kw),
                         device="cpu")


def test_tiny_run_is_healthy():
    rec = soak(_env(include_thermal=False), seconds=600, warmup_blocks=0, max_blocks=2)
    assert rec["healthy"] and rec["bad_blocks"] == 0 and rec["blocks"] == 2
    assert rec["env_steps"] == 2 * N_INNER * B and rec["env_steps_per_s"] > 0
    assert rec["failed_solve_fraction_mean"] == rec["failed_solve_fraction_max"] == 0.0
    assert rec["episodes_terminated"] + rec["episodes_truncated"] > 0
    assert rec["backend"] == "cpu" and rec["card"] is None


def test_thermal_short_pulses_fail_too_often():
    rec = soak(_env(), seconds=600, warmup_blocks=0, max_blocks=2)
    assert rec["bad_blocks"] == 0
    assert 0.05 < rec["failed_solve_fraction_mean"] < 0.2
    assert not rec["healthy"]


def test_poisoned_state_is_a_bad_block():
    env = _env(include_thermal=False)
    state, _ = env.reset(0)
    state = dataclasses.replace(state, total_energy=torch.full_like(state.total_energy,
                                                                    float("nan")))
    rec = soak(env, seconds=600, warmup_blocks=0, max_blocks=2, state=state)
    assert rec["bad_blocks"] >= 1 and not rec["healthy"]


def test_main_writes_the_record_and_exits_1_when_unhealthy(tmp_path, monkeypatch):
    verdict = {"healthy": False, "bad_blocks": 1}
    monkeypatch.setattr(soak_mod, "soak", lambda env, seconds: dict(verdict, batch=env.batch_size))
    out = tmp_path / "soak.json"
    assert soak_mod.main(["--device", "cpu", "--seconds", "1", "--out", str(out)]) == 1
    assert json.loads(out.read_text()) == dict(verdict, batch=4096)
    verdict["healthy"] = True
    assert soak_mod.main(["--device", "cpu", "--out", str(out)]) == 0
