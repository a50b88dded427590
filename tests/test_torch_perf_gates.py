"""The JAX package's throughput gates and reporting surfaces
(``tests/integration/test_perf_gates.py``) on the port, on the CPU.

* The reporting surfaces of ``GymSpinTorqueEnv(device="cpu")``: a healthy
  report, the solver's method and at least one device, held beside the
  JAX adapter's report of the same surfaces. A CPU env counts one device
  whether or not a card is present.
* The 4x4 array gate, >1 step/s over 20 steps of the global action, the
  reference's own number.

The single-env gate (>10 steps/s for SpinTorque-v0 with a 1 ns pulse) runs
on the card (``tests/test_torch_cuda.py``), the port's default device: its
plain-torch loop at B=1 issues hundreds of eager ops per RK4 substep and
does not reach 10 steps/s on a CPU.
"""

import time

import numpy as np
import torch

import spintorque_tpu.envs.gym_adapter as J
import spintorque_tpu_torch.envs.gym_adapter as T

torch.set_num_threads(1)


def test_env_reporting_surfaces():
    env = T.GymSpinTorqueEnv(include_thermal_fluctuations=False, device="cpu")
    env.reset(seed=0)
    health = env.get_health_report()
    assert health["status"] == "HEALTHY"
    solver = env.get_solver_info()
    assert solver["method"] == "rk4"
    stats = env.get_performance_stats()
    assert stats["devices"] >= 1
    assert stats["devices"] == 1 and stats["backend"] == "cpu"

    jenv = J.GymSpinTorqueEnv(include_thermal_fluctuations=False)
    jenv.reset(seed=0)
    assert jenv.get_health_report()["status"] == health["status"]
    jsolver = jenv.get_solver_info()
    for key in ("method", "noise_mode", "rk4_noise"):
        assert solver[key] == jsolver[key], key
    assert jenv.get_performance_stats()["devices"] >= 1


def test_array_env_faster_than_reference_gate():
    env = T.GymSpinTorqueArrayEnv(array_size=(4, 4), action_mode="global",
                                  dtype="float32", device="cpu")
    env.reset(seed=0)
    action = np.array([0.0, 1e5], np.float32)
    env.step(action)  # warm
    t0 = time.perf_counter()
    n = 20
    for _ in range(n):
        obs, r, te, tr, info = env.step(action)
        assert np.isfinite(obs).all() and np.isfinite(r)
        if te or tr:
            env.reset(seed=0)
    rate = n / (time.perf_counter() - t0)
    assert rate > 1, f"array-env rate {rate:.1f} steps/s under reference gate"
