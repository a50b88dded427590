"""The research tier's comparative, novel, validation and publication
modules against the JAX package's.

Counterpart of the nine classical tests of tests/unit/test_research_tier.py
(its quantum tests wait for the port of the quantum tier), on the CPU
(``device="cpu"``), plus the parts held to JAX:

  * ``OptimalControlBaseline.loss`` and its gradient in theta at a fixed
    theta, against ``jax.grad`` through the JAX trajectory (jitted): rtol
    1e-6 (the physics is float32 in both; the protocol float64);
  * ``PhysicsInformedRL``'s potential and shaping, float64: rtol 1e-12;
  * ``StatisticalAnalyzer.compare_groups`` and its tables: equal;
  * the seeded searches (meta-learner, annealer) by the JAX tests'
    thresholds, their random streams being torch's;
  * ``ResearchValidationFramework`` in float64 (as the JAX test runs under
    x64): every check passes; in float32 (the card's dtype) the other four
    pass and the measured convergence order is below 2;
  * a pole state with subnormal transverse components: the plain loop and
    the trajectory stay exactly at the pole, as JAX (XLA flushes
    subnormals) does; and the default optimal-control controller's
    starting draw on the card, replayed: every restart finite, restart 9's
    loss and gradient against ``jax.grad`` at rtol 1e-6.

Cut for time: ``test_optimal_control_switches_and_saves_energy`` runs 4 Adam
iterations where the JAX test runs 40 (each iteration is a forward and a
backward of 3 segments x 200 RK4 substeps through the plain loop, ~3 s on
one CPU thread; the thresholds hold from the first iterations); the
default controllers run one task with the optimal-control controller's
iterations cut to 2 (its 60 are asserted as passed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.physics.solver import params_from_dict as jax_params_from_dict
from spintorque_tpu.research import OptimalControlBaseline as JOptimalControl
from spintorque_tpu.research import PhysicsInformedRL as JPhysicsInformedRL
from spintorque_tpu.research import StatisticalAnalyzer as JStatisticalAnalyzer
from spintorque_tpu_torch.physics.solver import params_from_dict
from spintorque_tpu_torch.research import (
    AdaptiveMetaLearner,
    ComparativeAnalysis,
    Hypothesis,
    HypothesisDrivenExperimentEngine,
    OptimalControlBaseline,
    PhysicsInformedRL,
    PublicationFramework,
    QuantumInspiredSpintronicOptimizer,
    ResearchValidationFramework,
    StatisticalAnalyzer,
    run_comprehensive_benchmark,
)
from spintorque_tpu_torch.research import comparative_algorithms

torch.set_num_threads(1)

DEVICE = dict(volume=1e-24, saturation_magnetization=800e3, damping=0.05,
              uniaxial_anisotropy=4e5, polarization=0.7, easy_axis=np.array([0.0, 0.0, 1.0]))


def _params(dtype=torch.float32):
    return params_from_dict(DEVICE, dtype, device="cpu")


# ---------------------------------------------------------------------------
# optimal control


def test_optimal_control_switches_and_saves_energy():
    oc = OptimalControlBaseline(_params(), n_segments=3, segment_duration=2e-10,
                                max_substeps=256)
    out = oc.optimize(m_initial=(0.1, 0.0, 0.995), target=(0.0, 0.0, -1.0),
                      n_restarts=8, iterations=4)
    assert out["alignment"] > 0.8  # switched to the target well
    assert out["loss_history"][-1] <= out["loss_history"][0]
    assert len(out["loss_history"]) == 4
    # energy descent: best protocol uses well below the full drive budget
    assert out["energy_norm"] < 0.9
    assert out["currents"].shape == (3,)
    assert np.all(np.abs(out["currents"]) <= oc.max_current)


def test_optimal_control_loss_and_gradient_equal_jax():
    kw = dict(n_segments=3, segment_duration=2e-10, max_substeps=256)
    joc = JOptimalControl(jax_params_from_dict(DEVICE), **kw)
    oc = OptimalControlBaseline(_params(), **kw)
    assert oc.max_current == joc.max_current
    m0 = np.array([0.1, 0.0, 0.995], np.float32)
    m0 /= np.linalg.norm(m0)
    tgt = np.array([0.0, 0.0, -1.0], np.float32)
    thetas = np.array([[0.3, -0.8, 1.1], [-0.2, 0.5, 0.05]])
    # The restarts as rows of one batch: one backward of the summed loss
    # gives each row the gradient of its own protocol's loss.
    th = torch.tensor(thetas, requires_grad=True)
    rows = oc.loss(oc.max_current * torch.tanh(th), m0, tgt)
    rows.sum().backward()
    jloss = jax.jit(jax.value_and_grad(
        lambda t: joc.loss(joc.max_current * jnp.tanh(t), m0, tgt)))
    for i, theta in enumerate(thetas):
        want, want_grad = jloss(jnp.asarray(theta))
        np.testing.assert_allclose(float(rows[i]), float(want), rtol=1e-6)
        np.testing.assert_allclose(th.grad[i].numpy(), np.asarray(want_grad), rtol=1e-6,
                                   atol=1e-9)
    single = torch.tensor(thetas[0], requires_grad=True)
    assert oc.loss(oc.max_current * torch.tanh(single), m0, tgt).dim() == 0


def test_subnormal_states_follow_ieee_where_xla_flushes():
    """A state at the -z pole whose transverse components are float32
    subnormals (1e-38). XLA on the CPU flushes them to zero (as a TPU does),
    so the JAX pulse stays exactly at the pole, a fixed point. IEEE
    arithmetic would keep them, and a current that destabilizes the pole
    would grow them by ~e^58 over one optimal-control segment; the port
    flushes the state's subnormals on entry and after every substep, so its
    plain loop and its trajectory stay at the pole exactly as JAX does."""
    from spintorque_tpu.physics import IntegratorConfig as JConfig
    from spintorque_tpu.physics import integrate_pulse as jax_pulse
    from spintorque_tpu_torch.physics import (
        IntegratorConfig,
        integrate_pulse_plain,
        integrate_pulse_trajectory,
    )

    m = np.array([[1e-38], [1e-38], [-1.0]], np.float32)
    kw = dict(method="rk4", max_substeps=512)
    jdp = dict(DEVICE, damping=0.01, uniaxial_anisotropy=8e5)
    want = jax.jit(lambda: jax_pulse(
        tuple(jnp.asarray(x) for x in m), jnp.asarray([2.5e-10], jnp.float32),
        jnp.asarray([-2.7e-7], jnp.float32), jax_params_from_dict(jdp), JConfig(**kw)))()
    args = (tuple(torch.from_numpy(x) for x in m), torch.tensor([2.5e-10]),
            torch.tensor([-2.7e-7]), params_from_dict(jdp, device="cpu"), IntegratorConfig(**kw))
    got = integrate_pulse_plain(*args)
    traj_result, traj = integrate_pulse_trajectory(*args)
    assert [float(x[0]) for x in want.m] == [0.0, 0.0, -1.0]
    assert [float(x[0]) for x in got.m] == [0.0, 0.0, -1.0]
    assert [float(x[0]) for x in traj_result.m] == [0.0, 0.0, -1.0]
    assert traj[-1, :, 0].tolist() == [0.0, 0.0, -1.0]
    assert int(got.n_substeps[0]) == int(want.n_substeps[0])


# The 16 x 3 starting angles of the default optimal-control controller's
# restarts in chip_smoke.py: 0.5 * N(0, 1) from a CUDA torch.Generator seeded
# with 0 (torch 2.11 + CUDA 12.8 on an NVIDIA H100 80GB HBM3). Before the
# subnormal flush, restart 9 left the -z pole through subnormal transverse
# components and its gradient overflowed to NaN on the card.
CARD_THETA0 = np.array([
    [-0.15519786800018825, -0.01716406615204757, 0.08779736365952064],
    [-1.1401907173518908, 0.2519297577669567, 0.27981234197806093],
    [-0.037481062885915316, 0.48453333432952395, -0.11782983762947494],
    [-0.22910378980515736, 0.2830371547157912, 0.6425512104734218],
    [-0.933334922377163, -0.015613344602770494, 0.6216551080417145],
    [0.6844462320800497, -0.5376525757150841, -0.007879856143821543],
    [-0.7240646801299467, -0.6544344522034166, 0.3489943665054127],
    [-0.16502089480222942, -0.38541289833691267, -0.2472827367579652],
    [1.5851110687420966, 0.01936598743646253, -0.7863801145514805],
    [0.6492488047836286, -0.2209275917876018, -0.34824676846598884],
    [-0.7001201248507641, -0.04419710148779297, -0.11844023677749305],
    [-0.2978150742813435, -0.013171422945612087, 0.02728838888524853],
    [-0.3541242094494132, 0.03210986113971867, 0.6415015051084457],
    [-0.9363852418603364, 0.3780867446450698, -0.3172339407935007],
    [0.5587883635645503, 0.6690922505365962, 0.09967891299401087],
    [0.03355086507651537, -0.20796367044473613, 0.07338595273937419],
])


def test_optimal_control_replays_the_cards_draw():
    """The default controller's task and device, from the card's seed-0
    draw: every restart's loss and gradient are finite, and restart 9's
    (the one that passes the pole) agree with ``jax.grad`` at the
    tolerance of the optimal-control parity test."""
    params = dict(DEVICE, damping=0.01, uniaxial_anisotropy=8e5)
    analysis = ComparativeAnalysis(params_from_dict(params, device="cpu"))
    m0, tgt = analysis.default_tasks(1)[0]
    oc = OptimalControlBaseline(analysis.params, n_segments=3)
    joc = JOptimalControl(jax_params_from_dict(params), n_segments=3)
    assert oc.max_current == joc.max_current
    th = torch.tensor(CARD_THETA0, requires_grad=True)
    losses = oc.loss(oc.max_current * torch.tanh(th), m0, tgt)
    (grad,) = torch.autograd.grad(losses.sum(), th)
    assert torch.isfinite(losses).all() and torch.isfinite(grad).all()
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda t: joc.loss(joc.max_current * jnp.tanh(t), m0, tgt)))(jnp.asarray(CARD_THETA0[9]))
    np.testing.assert_allclose(float(losses[9]), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad[9].numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-9)


def test_physics_informed_shaping_is_potential_based():
    pi = PhysicsInformedRL(_params(), gamma=1.0)
    target = torch.tensor([0.0, 0.0, -1.0])
    m_a = torch.tensor([0.0, 0.0, 1.0])
    m_b = torch.tensor([1.0, 0.0, 0.0])
    # telescoping: shaping(a->b) + shaping(b->a) == 0 for gamma=1
    total = pi.shaping(m_a, m_b, target) + pi.shaping(m_b, m_a, target)
    assert abs(float(total)) < 1e-5
    # moving toward the target raises the potential
    assert float(pi.potential(target, target)) > float(pi.potential(m_a, target))


def test_physics_informed_shaping_equals_jax():
    rng = np.random.default_rng(2)
    m = rng.normal(size=(2, 16, 3))
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    target = np.array([0.0, 0.0, -1.0])
    jpi = JPhysicsInformedRL(jax_params_from_dict(DEVICE, jnp.float64), gamma=0.9, weight=0.3)
    pi = PhysicsInformedRL(_params(torch.float64), gamma=0.9, weight=0.3)
    t = [torch.from_numpy(x) for x in (m[0], m[1], target)]
    j = [jnp.asarray(x) for x in (m[0], m[1], target)]
    np.testing.assert_allclose(pi.potential(t[0], t[2]).numpy(),
                               np.asarray(jpi.potential(j[0], j[2])), rtol=1e-12)
    np.testing.assert_allclose(pi.shaping(*t).numpy(), np.asarray(jpi.shaping(*j)), rtol=1e-12)
    shaping = pi.reward_components()["physics_shaping"]["function"]
    info = {"m_prev": t[0], "m": t[1], "target": t[2]}
    assert torch.equal(shaping(None, None, None, info), pi.shaping(*t))


def test_comparative_analysis_report_structure():
    analysis = ComparativeAnalysis(_params(), seed=0)

    def fake_good(task):
        return {"alignment": 0.99, "energy_J": 1e-13}

    def fake_bad(task):
        return {"alignment": -0.9, "energy_J": 0.0}

    analysis.register("good", fake_good)
    analysis.register("bad", fake_bad)
    report = analysis.run(analysis.default_tasks(3))
    assert report["methods"]["good"]["success_rate"] == 1.0
    assert report["methods"]["bad"]["success_rate"] == 0.0


def test_default_controllers_run(monkeypatch):
    """The default ``optimal_control`` controller passes ``iterations=60``
    to ``optimize`` (the JAX package passes it to the constructor and
    raises TypeError); iterations cut to 2 here for time."""
    calls = []
    optimize = comparative_algorithms.OptimalControlBaseline.optimize

    def recording(self, *args, **kwargs):
        calls.append(kwargs)
        return optimize(self, *args, **dict(kwargs, iterations=2))

    monkeypatch.setattr(comparative_algorithms.OptimalControlBaseline, "optimize", recording)
    report = run_comprehensive_benchmark(n_tasks=1, device="cpu")
    assert calls == [dict(n_restarts=16, iterations=60)]
    assert set(report["methods"]) == {"optimal_control", "single_pulse_grid", "do_nothing"}
    for stats in report["methods"].values():
        assert np.isfinite(stats["mean_alignment"])
    assert report["config"] == {"n_tasks": 1, "seed": 0}


# ---------------------------------------------------------------------------
# novel algorithms


def _quadratic_objective(d):
    return (d["a"] - 0.25) ** 2 + (d["b"] + 0.4) ** 2


def test_meta_learner_tracks_scores():
    ml = AdaptiveMetaLearner(seed=0, device="cpu")
    for s in range(3):
        res = ml.solve(_quadratic_objective, {"a": (-1, 1), "b": (-1, 1)}, seed=s)
        assert res.best_value < 0.05
    report = ml.meta_report()
    assert report["tasks_solved"] == 3


def test_quantum_inspired_optimizer_converges():
    opt = QuantumInspiredSpintronicOptimizer(population=256, iterations=25, seed=0, device="cpu")
    res = opt.optimize(_quadratic_objective, {"a": (-1, 1), "b": (-1, 1)})
    assert res.best_value < 0.01
    assert res.method == "quantum_inspired_annealing"
    # history is monotone non-increasing (best-so-far)
    assert all(b <= a + 1e-9 for a, b in zip(res.history, res.history[1:]))


def test_hypothesis_engine_with_correction():
    eng = HypothesisDrivenExperimentEngine(alpha=0.05)
    rng = np.random.default_rng(0)

    eng.register_experiment("fast", lambda seed: {"score": 1.0 + 0.01 * rng.standard_normal()})
    eng.register_experiment("slow", lambda seed: {"score": 0.0 + 0.01 * rng.standard_normal()})

    def real_diff(results):
        from spintorque_tpu_torch.research.benchmarking import significance_test

        stats = significance_test(results["fast.score"], results["slow.score"])
        return stats, stats["t_statistic"] > 0

    def null_diff(results):
        from spintorque_tpu_torch.research.benchmarking import significance_test

        half = len(results["fast.score"]) // 2
        stats = significance_test(results["fast.score"][:half], results["fast.score"][half:])
        return stats, True

    eng.register_hypothesis(Hypothesis("real", "fast > slow", real_diff))
    eng.register_hypothesis(Hypothesis("null", "fast first half > second", null_diff))
    eng.run_experiments(n_repeats=12)
    report = eng.evaluate()
    by_name = {h["name"]: h for h in report["hypotheses"]}
    assert by_name["real"]["status"] == "supported"
    assert by_name["null"]["status"] == "rejected"
    with pytest.raises(ValueError):
        eng.register_hypothesis(Hypothesis("real", "again", real_diff))


# ---------------------------------------------------------------------------
# validation + publication


def test_research_validation_passes():
    """float64 on the CPU, as the JAX test runs under x64."""
    report = ResearchValidationFramework(dtype=torch.float64, device="cpu").run_all()
    failing = [c for c in report["checks"] if not c["passed"]]
    assert report["passed"], f"failing checks: {failing}"
    assert [c["name"] for c in report["checks"]] == [
        "norm_preservation", "seed_determinism", "zero_damping_energy", "convergence_order",
        "equilibrium_stability"]


def test_research_validation_in_float32():
    """float32, the card's dtype: four checks pass; RK4's error at the
    order check's steps lies below float32's rounding, so the order it
    measures falls short of 2."""
    report = ResearchValidationFramework(dtype=torch.float32, device="cpu").run_all()
    by_name = {c["name"]: c for c in report["checks"]}
    assert all(c["passed"] for n, c in by_name.items() if n != "convergence_order"), by_name
    order = by_name["convergence_order"]
    assert "error" not in order and order["measured_order"] < 2.0 and not order["passed"]


def test_statistical_analyzer_holm_correction():
    rng = np.random.default_rng(0)
    groups = {
        "a": rng.normal(0.0, 1.0, 30),
        "b": rng.normal(3.0, 1.0, 30),  # clearly different
        "c": rng.normal(0.05, 1.0, 30),  # same as a
    }
    out = StatisticalAnalyzer().compare_groups(groups)
    pair = {(p["a"], p["b"]): p for p in out["pairwise"]}
    assert pair[("a", "b")]["significant_after_correction"]
    assert not pair[("a", "c")]["significant_after_correction"]


def test_statistical_analyzer_equals_jax():
    rng = np.random.default_rng(4)
    groups = {k: rng.normal(mu, 1.0, 20) for k, mu in (("x", 0.0), ("y", 0.8), ("z", 0.1))}
    got = StatisticalAnalyzer(alpha=0.1).compare_groups(groups)
    want = JStatisticalAnalyzer(alpha=0.1).compare_groups(groups)
    assert got == want
    assert (StatisticalAnalyzer.to_markdown_table(got["descriptives"])
            == JStatisticalAnalyzer.to_markdown_table(want["descriptives"]))
    assert (StatisticalAnalyzer.to_latex_table(got["descriptives"], "T")
            == JStatisticalAnalyzer.to_latex_table(want["descriptives"], "T"))


def test_publication_framework_generates_report(tmp_path):
    pub = PublicationFramework(output_dir=tmp_path / "pub")
    rng = np.random.default_rng(0)
    pub.add_experiment(
        "switching_energy",
        {"optimal": rng.normal(1.0, 0.1, 10), "baseline": rng.normal(2.0, 0.1, 10)},
    )
    path = pub.generate_report("Test Report")
    text = open(path).read()
    assert "switching_energy" in text and "Reproducibility" in text
    assert (tmp_path / "pub" / "manifest.json").exists()
    assert (tmp_path / "pub" / "figures" / "switching_energy_bars.png").exists()
    manifest = PublicationFramework.reproducibility_manifest({"seed": 3})
    assert manifest["torch_version"] == torch.__version__ and manifest["seed"] == 3
    assert "jax_version" not in manifest
