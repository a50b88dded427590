"""The research tier's optimizers and benchmark harness against the JAX
package's.

Counterpart of tests/unit/test_research.py: its six tests, each at its own
size, on the CPU (``device="cpu"``), and beside them the deterministic parts
held to JAX:

  * ``grid_search`` on the quadratic: the best point at rtol 1e-12 (torch's
    and JAX's float64 ``linspace`` differ in the last bit) and the best
    value at atol 1e-24 (both ~0); on ``switching_objective`` (float32
    physics): the same best index, the best value at rtol 2e-6;
  * ``switching_objective``'s values against the JAX objective run op by
    op (``jax.disable_jit``: jitted XLA fuses multiply-adds, and float32
    pulses that switch drift ~1e-5 from it) on the same float32 candidates
    of the smooth current regime: rtol = atol = 2e-6 (the pulse contract);
  * ``bootstrap_ci``, ``significance_test``: equal, value for value;
  * the seeded optimizers (cross-entropy, annealing) draw from a
    ``torch.Generator``, another stream than JAX's: they are held to the
    JAX tests' thresholds, and on the switching objective to a best value
    within 0.02 of JAX's at the same settings;
  * ``compare_policies``: the same keys as JAX's report; with the same
    policy under two names, the two rows are equal and their Welch test
    finds no difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.envs import SpinTorqueEnv as JEnv
from spintorque_tpu.envs import SpinTorqueEnvConfig as JEnvConfig
from spintorque_tpu.parallel import random_policy as jax_random_policy
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.physics import IntegratorConfig as JConfig
from spintorque_tpu.research import bootstrap_ci as jax_bootstrap_ci
from spintorque_tpu.research import compare_policies as jax_compare_policies
from spintorque_tpu.research import cross_entropy as jax_cross_entropy
from spintorque_tpu.research import grid_search as jax_grid_search
from spintorque_tpu.research import significance_test as jax_significance_test
from spintorque_tpu.research import switching_objective as jax_switching_objective
from spintorque_tpu_torch.envs import SpinTorqueEnv, SpinTorqueEnvConfig
from spintorque_tpu_torch.parallel import random_policy
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams
from spintorque_tpu_torch.research import (
    BenchmarkSuite,
    bootstrap_ci,
    compare_policies,
    create_standard_benchmark_suite,
    cross_entropy,
    grid_search,
    optimize_switching_pulse,
    significance_test,
    simulated_annealing,
    switching_objective,
)

torch.set_num_threads(1)

VALUES = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
              volume=1e-23, polarization=0.7)
PARAMS = LLGSParams(**{k: torch.tensor(v) for k, v in VALUES.items()},
                    easy_axis=torch.tensor([0.0, 0.0, 1.0]), plus_z=True)
JAX_PARAMS = JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in VALUES.items()},
                     easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float32))
SHORT = dict(method="rk4", max_substeps=256)  # pulses up to 2e-10 s


def quadratic(params):
    x, y = params["x"], params["y"]
    return (x - 0.3) ** 2 + (y + 0.7) ** 2


SPACE = {"x": (-2.0, 2.0), "y": (-2.0, 2.0)}
# Currents of the smooth regime (~1e-5 A/m^2 for this device): at the
# default space's +-2e6 every pulse blows up in float32 and normalizes to
# +z, in both packages, and the objective is 2.0 everywhere.
PULSES = {"current": (-2e-5, 2e-5), "duration": (1e-11, 2e-10)}


# ------------------------------------------------- test_research.py's tests


def test_grid_search_finds_minimum():
    res = grid_search(quadratic, SPACE, points_per_dim=41, device="cpu")
    assert abs(res.best_params["x"] - 0.3) < 0.06
    assert abs(res.best_params["y"] + 0.7) < 0.06
    assert res.n_evaluations == 41 * 41


def test_cross_entropy_converges():
    res = cross_entropy(quadratic, SPACE, population=256, elites=32, iterations=15, device="cpu")
    assert res.best_value < 1e-3
    assert res.history[-1] <= res.history[0]


def test_simulated_annealing_converges():
    res = simulated_annealing(quadratic, SPACE, chains=128, iterations=60, device="cpu")
    assert res.best_value < 1e-2


def test_optimize_switching_pulse_runs():
    res = optimize_switching_pulse(
        PARAMS, method="cross_entropy", population=64, elites=8, iterations=3,
        max_duration=2e-10,
    )
    assert np.isfinite(res.best_value)
    assert "current" in res.best_params and "duration" in res.best_params
    assert res.n_evaluations == 64 * 3 and len(res.history) == 3


def test_statistics():
    rng = np.random.default_rng(0)
    a = rng.normal(1.0, 0.1, 50)
    b = rng.normal(0.0, 0.1, 50)
    sig = significance_test(a, b)
    assert sig["p_value"] < 1e-6
    lo, hi = bootstrap_ci(a)
    assert lo < 1.0 < hi


def _zero_policy(params, obs, generator):
    return torch.zeros((obs.shape[0], 2), dtype=obs.dtype, device=obs.device)


def test_compare_policies():
    env = SpinTorqueEnv(batch_size=8, device="cpu", config=SpinTorqueEnvConfig(
        include_thermal=False, max_duration=1e-10, dtype="float32"))
    report = compare_policies(env, {"random": random_policy(env), "zero": _zero_policy},
                              horizon=5)
    assert set(report["policies"]) == {"random", "zero"}
    assert "random_vs_zero" in report["significance"]


# -------------------------------------------------------- held to JAX


def test_statistics_equal_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(0.3, 1.0, 40), rng.normal(0.0, 2.0, 25)
    assert significance_test(a, b) == jax_significance_test(a, b)
    assert bootstrap_ci(a, n_boot=500, seed=3) == jax_bootstrap_ci(a, n_boot=500, seed=3)


def test_grid_search_on_the_quadratic_equals_jax():
    want = jax_grid_search(quadratic, SPACE, points_per_dim=41)
    got = grid_search(quadratic, SPACE, points_per_dim=41, device="cpu")
    for k in SPACE:
        np.testing.assert_allclose(got.best_params[k], want.best_params[k], rtol=1e-12)
    np.testing.assert_allclose(got.best_value, want.best_value, rtol=0, atol=1e-24)
    assert got.n_evaluations == want.n_evaluations and got.method == want.method


def test_switching_objective_equals_jax():
    rng = np.random.default_rng(7)
    cand = dict(current=rng.uniform(-2e-5, 2e-5, 96).astype(np.float32),
                duration=rng.uniform(1e-11, 2e-10, 96).astype(np.float32))
    with jax.disable_jit():
        want = np.asarray(jax_switching_objective(JAX_PARAMS, config=JConfig(**SHORT))(
            {k: jnp.asarray(v) for k, v in cand.items()}))
    got = switching_objective(PARAMS, config=IntegratorConfig(**SHORT))(
        {k: torch.from_numpy(v) for k, v in cand.items()})
    assert got.dtype == torch.float32 and got.shape == (96,)
    assert want.min() < 0.5 and want.max() > 1.5  # pulses that switch and pulses that do not
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    # A target and start of the caller's, and no energy term.
    kw = dict(m_initial=(0.3, 0.2, 0.9), target=(1.0, 0.0, 0.0), energy_weight=0.0)
    with jax.disable_jit():
        want = np.asarray(jax_switching_objective(JAX_PARAMS, config=JConfig(**SHORT), **kw)(
            {k: jnp.asarray(v) for k, v in cand.items()}))
    got = switching_objective(PARAMS, config=IntegratorConfig(**SHORT), **kw)(
        {k: torch.from_numpy(v) for k, v in cand.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_grid_search_on_the_switching_objective_equals_jax():
    want = jax_grid_search(jax_switching_objective(JAX_PARAMS, config=JConfig(**SHORT)),
                           PULSES, points_per_dim=8)
    got = grid_search(switching_objective(PARAMS, config=IntegratorConfig(**SHORT)), PULSES,
                      points_per_dim=8, device="cpu")
    for k in PULSES:
        np.testing.assert_allclose(got.best_params[k], want.best_params[k], rtol=1e-12)
    np.testing.assert_allclose(got.best_value, want.best_value, rtol=2e-6)


def test_cross_entropy_on_the_switching_objective_reaches_jax():
    kw = dict(population=64, elites=8, iterations=3)
    want = jax_cross_entropy(jax_switching_objective(JAX_PARAMS, config=JConfig(**SHORT)),
                             PULSES, **kw)
    got = cross_entropy(switching_objective(PARAMS, config=IntegratorConfig(**SHORT)), PULSES,
                        device="cpu", **kw)
    assert abs(got.best_value - want.best_value) < 0.02
    assert all(lo <= got.best_params[k] <= hi for k, (lo, hi) in PULSES.items())


def test_seeded_optimizers_are_reproducible():
    kw = dict(device="cpu", seed=5)
    for run in (lambda: cross_entropy(quadratic, SPACE, population=64, iterations=4, **kw),
                lambda: simulated_annealing(quadratic, SPACE, chains=32, iterations=8, **kw)):
        a, b = run(), run()
        assert a.best_params == b.best_params and np.array_equal(a.history, b.history)
    other = cross_entropy(quadratic, SPACE, population=64, iterations=4, device="cpu", seed=6)
    assert other.best_params != cross_entropy(quadratic, SPACE, population=64, iterations=4,
                                              **kw).best_params


def test_compare_policies_report_matches_jax_keys():
    jenv = JEnv(batch_size=8, config=JEnvConfig(include_thermal=False, max_duration=1e-10,
                                                dtype="float32"))
    want = jax_compare_policies(jenv, {"random": jax_random_policy(jenv)}, horizon=3)
    env = SpinTorqueEnv(batch_size=8, device="cpu", config=SpinTorqueEnvConfig(
        include_thermal=False, max_duration=1e-10, dtype="float32"))
    policy = random_policy(env)
    got = compare_policies(env, {"random": policy, "same": policy}, horizon=3)
    assert set(got["policies"]["random"]) == set(want["policies"]["random"])
    assert got["policies"]["random"] == got["policies"]["same"]
    sig = got["significance"]["random_vs_same"]
    assert sig["cohens_d"] == 0.0 and not sig["p_value"] < 0.05
    assert got["policies"]["random"]["steps"] == 8 * 3


def test_benchmark_suite_reports_on_the_cpu(tmp_path):
    """The suite's report with the solver scenario at a small size; the
    standard suite (its env scenarios step 5 ns pulses: minutes on the
    CPU's plain loop) runs on the card in chip_smoke.py."""
    from spintorque_tpu_torch.research.benchmarking import BenchmarkResult, _solver_scenario

    suite = BenchmarkSuite(device="cpu")
    suite.register("solver", _solver_scenario(64, 20, "cpu"))
    suite.register("fixed", lambda: BenchmarkResult("fixed", 2.0, "units"))
    report = suite.run_and_save(tmp_path / "bench.json")
    assert report["backend"] == "cpu" and report["card"] is None
    assert report["results"]["solver"]["unit"] == "pulses/s"
    assert report["results"]["solver"]["value"] > 0
    fixed = report["results"]["fixed"]
    assert fixed["value"] == 2.0 and "wall_s" in fixed["extra"]
    assert (tmp_path / "bench.json").is_file()
    assert set(create_standard_benchmark_suite(device="cpu")._scenarios) == {
        "solver_4096x1000", "env_4096_thermal", "env_4096_det"}
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError):
            BenchmarkSuite()


def test_research_exports_every_classical_jax_name():
    """Every name of the JAX package's research tier, the classical ones
    and, since the quantum tier is ported, the quantum half's six."""
    import spintorque_tpu.research as jax_research
    import spintorque_tpu_torch.research as research

    quantum = {"QuantumNeuralNetwork", "QuantumReinforcementLearning", "QuantumSpinOptimizer",
               "QuantumSpintronicBenchmark", "QuantumSpintronicOptimizer",
               "QuantumValidationFramework"}
    assert quantum <= set(jax_research.__all__)
    assert not set(jax_research.__all__) - set(research.__all__)
    for name in research.__all__:
        assert hasattr(research, name), name
