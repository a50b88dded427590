"""spintorque_tpu_torch.physics.thermal and .materials against the JAX
package's, and the thermal physics gates of the port's pulse integrator.

The same inputs go through both packages. Tolerances:
  * the material database: the port's copy holds the same data and gives
    the same derived properties exactly;
  * the deterministic thermal analytics (noise strength, Neel-Brown
    barrier, switching probability, retention, the stability report and
    the temperature sweep), float64: rtol 1e-12, and atol 4.5e-16 (two
    ulps of 1) on the switching probability 1 - exp(-r t), which cancels
    near 0, so that one ulp of the two libraries' exp shows in full;
  * the draws (the thermal field, the switching times): the port draws
    from a torch.Generator and JAX from split keys, so they are held in
    distribution: KS tests at p > 1e-3 against the analytic law and
    against JAX's own draws;
  * the JAX package's always-on physics gates of the physical noise mode
    (tests/unit/test_thermal_physical_validation.py: Boltzmann equilibrium
    and the Neel-Brown switching rate, scaled variants, with their
    bounds), run through the port's plain pulse on the CPU. The two
    full-size gates are marked slow in the JAX package and are not ported;
    chip_smoke.py runs the equilibrium gate through the kernel.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate as sp_integrate
from scipy import stats

from spintorque_tpu.physics import MaterialDatabase as JDatabase
from spintorque_tpu.physics import ThermalFluctuations as JThermal
from spintorque_tpu_torch.constants import GAMMA, KB, KB_SOLVER, MU0
from spintorque_tpu_torch.physics import (
    IntegratorConfig,
    LLGSParams,
    MaterialDatabase,
    ThermalFluctuations,
    integrate_pulse,
)
from spintorque_tpu_torch.physics.materials import MaterialProperties

torch.set_num_threads(1)


def _thermal(**kw):
    return ThermalFluctuations(device="cpu", **kw)


# ------------------------------------------------------------- materials


def test_database_is_the_jax_packages():
    ours, theirs = MaterialDatabase(), JDatabase()
    assert ours.list_materials() == theirs.list_materials()
    for name in ours.list_materials():
        assert vars(ours.get_material(name)) == vars(theirs.get_material(name))
        for t in (250.0, 400.0, np.array([100.0, 700.0])):
            a, b = vars(ours.get_temperature_adjusted(name, t)), vars(
                theirs.get_temperature_adjusted(name, t))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}.{k}")
    assert vars(ours.create_bilayer("CoFeB", "Pt", 1e-9, 3e-9)) == vars(
        theirs.create_bilayer("CoFeB", "Pt", 1e-9, 3e-9))
    for device in ("stt_mram", "SOT_MRAM", "vcma_mram", "skyrmion", "other"):
        assert ours.recommend_materials(device) == theirs.recommend_materials(device)


def test_database_contents():
    db = MaterialDatabase()
    assert {"CoFeB", "Fe", "Co", "Ni", "Pt", "Ta", "W"} <= set(db.list_materials())
    cofeb = db.get_material("CoFeB")
    assert cofeb.saturation_magnetization == 800e3
    assert cofeb.spin_polarization == 0.7
    with pytest.raises(KeyError):
        db.get_material("Unobtainium")


def test_temperature_adjustment():
    db = MaterialDatabase()
    hot = db.get_temperature_adjusted("CoFeB", 400.0)
    cold = db.get_temperature_adjusted("CoFeB", 300.0)
    assert hot.saturation_magnetization < cold.saturation_magnetization
    assert hot.uniaxial_anisotropy < cold.uniaxial_anisotropy


def test_bilayer_and_json_roundtrip(tmp_path):
    db = MaterialDatabase()
    bi = db.create_bilayer("CoFeB", "Co", 1e-9, 1e-9)
    a, b = db.get_material("CoFeB"), db.get_material("Co")
    np.testing.assert_allclose(bi.saturation_magnetization,
                               (a.saturation_magnetization + b.saturation_magnetization) / 2)
    path = tmp_path / "mats.json"
    db.export_json(path)
    db2 = MaterialDatabase(custom_materials={})
    db2.import_json(path)
    assert db2.get_material("CoFeB").gilbert_damping == a.gilbert_damping
    # The JAX package reads the port's file and the other way round.
    JDatabase().export_json(tmp_path / "jax.json")
    assert json.loads((tmp_path / "jax.json").read_text()) == json.loads(path.read_text())


def test_custom_material_and_recommendations():
    custom = MaterialProperties(
        name="TestAlloy", saturation_magnetization=1e6, exchange_constant=1e-11,
        gilbert_damping=0.02, uniaxial_anisotropy=5e5, g_factor=2.0,
        curie_temperature=700, density=8000, resistivity=1e-7, spin_polarization=0.5,
    )
    db = MaterialDatabase(custom_materials={"TestAlloy": custom})
    assert db.get_material("TestAlloy").spin_polarization == 0.5
    assert db.recommend_materials("sot_mram").get("heavy_metal") == "Pt"


# ---------------------------------------------------------- thermal analytics


@pytest.mark.parametrize("temperature", [0.0, 77.0, 300.0, 600.0])
def test_analytics_match_jax(temperature):
    ours, theirs = _thermal(temperature=temperature), JThermal(temperature=temperature)
    rng = np.random.default_rng(int(temperature))
    alpha, ms, vol = rng.uniform(0.005, 0.1, 8), rng.uniform(3e5, 1.5e6, 8), rng.uniform(
        1e-25, 1e-22, 8)
    k_u = rng.uniform(1e5, 2e6, 8)
    barrier = k_u * vol

    def close(a, b, atol=0.0):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=atol)

    close(ours.compute_noise_strength(alpha, ms, vol), theirs.compute_noise_strength(
        jnp.asarray(alpha), jnp.asarray(ms), jnp.asarray(vol)))
    close(ours.compute_noise_strength(0.01, 800e3, 1e-24),
          theirs.compute_noise_strength(0.01, 800e3, 1e-24))
    close(ours.compute_thermal_barrier(k_u, vol), theirs.compute_thermal_barrier(
        jnp.asarray(k_u), jnp.asarray(vol)))
    if temperature > 0:
        for mt in (1e-9, 3.15e8):
            # 1 - exp(-r t) cancels near 0: an ulp of exp is an ulp of 1.
            close(ours.compute_switching_probability(barrier * 1e-3, measurement_time=mt),
                  theirs.compute_switching_probability(jnp.asarray(barrier * 1e-3),
                                                       measurement_time=mt), atol=4.5e-16)
        close(ours.compute_retention_time(barrier), theirs.compute_retention_time(
            jnp.asarray(barrier)))
        dp = {"volume": 1e-23, "uniaxial_anisotropy": 1.2e6}
        a, b = ours.analyze_thermal_stability(dp), theirs.analyze_thermal_stability(dp)
        assert a.keys() == b.keys() and a["is_thermally_stable"] == b["is_thermally_stable"]
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12)
    else:
        assert not ours.compute_switching_probability(barrier).any()
        assert torch.isinf(ours.compute_retention_time(barrier)).all()
    sweep_dp = {"volume": 1e-24, "uniaxial_anisotropy": 8e5, "damping": 0.01,
                "saturation_magnetization": 800e3}
    a = ours.generate_temperature_sweep((100.0, 500.0), sweep_dp, n_points=16)
    b = theirs.generate_temperature_sweep((100.0, 500.0), sweep_dp, n_points=16)
    for k in b:
        close(a[k], b[k])


def test_thermal_noise_strength_scaling():
    t = _thermal(temperature=300.0)
    s300 = float(t.compute_noise_strength(0.01, 800e3, 1e-24))
    t.set_temperature(600.0)
    s600 = float(t.compute_noise_strength(0.01, 800e3, 1e-24))
    np.testing.assert_allclose(s600 / s300, np.sqrt(2.0), rtol=1e-6)
    t.set_temperature(0.0)
    assert float(t.compute_noise_strength(0.01, 800e3, 1e-24)) == 0.0


def test_neel_brown_statistics():
    t = _thermal(temperature=300.0)
    delta = float(t.compute_thermal_barrier(1.2e6, 1e-23))
    barrier = 1.2e6 * 1e-23
    assert float(t.compute_switching_probability(barrier, measurement_time=1e-9)) < 1e-10
    assert float(t.compute_retention_time(barrier)) > 1e6
    report = t.analyze_thermal_stability({"volume": 1e-23, "uniaxial_anisotropy": 1.2e6})
    assert report["is_thermally_stable"]
    np.testing.assert_allclose(report["thermal_stability_factor"], delta)


def test_temperature_sweep_vectorized():
    sweep = _thermal(temperature=300.0).generate_temperature_sweep(
        (100.0, 500.0), {"volume": 1e-24, "uniaxial_anisotropy": 8e5, "damping": 0.01,
                         "saturation_magnetization": 800e3}, n_points=16)
    assert sweep["temperature"].shape == (16,)
    assert (torch.diff(sweep["thermal_stability_factor"]) < 0).all()
    assert (torch.diff(sweep["noise_strength"]) > 0).all()


def test_correlated_noise_generation():
    t = _thermal(temperature=300.0, correlation_time=1e-12, seed=3)
    f1 = t.generate_thermal_field(0.01, 800e3, 1e-24, dt=1e-13)
    f2 = t.generate_thermal_field(0.01, 800e3, 1e-24, dt=1e-13)
    assert f1.shape == (3,) and torch.isfinite(f1).all()
    assert not torch.allclose(f1, f2)
    assert float(t.sample_switching_time(1.38e-23 * 300 * 5)) > 0
    # Seeded: the same seed draws the same fields.
    again = _thermal(temperature=300.0, correlation_time=1e-12, seed=3)
    assert torch.equal(again.generate_thermal_field(0.01, 800e3, 1e-24, dt=1e-13), f1)


def test_draws_match_jax_in_distribution():
    """White fields are N(0, sigma^2) per component, the correlated field
    keeps that variance, and switching times are exponential at the
    Neel-Brown rate: each KS p > 1e-3, against the law and against JAX."""
    n = 4096
    ours, theirs = _thermal(seed=1), JThermal(seed=1)
    sigma = float(ours.compute_noise_strength(0.01, 800e3, 1e-24))
    white = ours.generate_thermal_field(0.01, 800e3, 1e-24, dt=1e-13, correlated=False,
                                        shape=(n,)).numpy()
    jwhite = np.asarray(theirs.generate_thermal_field(0.01, 800e3, 1e-24, dt=1e-13,
                                                      correlated=False, shape=(n,)))
    assert white.shape == jwhite.shape == (n, 3)
    for c in range(3):
        assert stats.kstest(white[:, c] / sigma, "norm").pvalue > 1e-3
        assert stats.ks_2samp(white[:, c], jwhite[:, c]).pvalue > 1e-3
    corr = np.stack([ours.generate_thermal_field(0.01, 800e3, 1e-24, dt=1e-11).numpy()
                     for _ in range(600)])  # dt >> correlation time: near white
    assert stats.kstest(corr[:, 0] / sigma, "norm").pvalue > 1e-3
    barrier = KB * 300.0 * 3.0
    rate = 1e9 * np.exp(-3.0)
    times = ours.sample_switching_time(barrier, shape=(n,)).numpy()
    jtimes = np.asarray(theirs.sample_switching_time(barrier, shape=(n,)))
    assert stats.kstest(times * rate, "expon").pvalue > 1e-3
    assert stats.ks_2samp(times, jtimes).pvalue > 1e-3


def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ThermalFluctuations()
    assert _thermal().generator.device.type == "cpu"


# ------------------- the physical noise mode's gates, through the port's pulse

MS, VOL, TEMP = 800e3, 1e-25, 300.0
KT = KB_SOLVER * TEMP
K_DEMAG = 0.5 * MU0 * MS**2


def _params(delta_eff, alpha):
    k_u = delta_eff * KT / VOL + K_DEMAG
    vals = dict(saturation_magnetization=MS, damping=alpha, uniaxial_anisotropy=k_u, volume=VOL,
                polarization=0.7)
    return LLGSParams(**{k: torch.tensor(v, dtype=torch.float32) for k, v in vals.items()},
                      easy_axis=torch.tensor([0.0, 0.0, 1.0]))


def _config(dt, span):
    return IntegratorConfig(method="heun", max_step=dt, max_substeps=int(span / dt) + 10,
                            thermal=True, noise_mode="physical")


def _fp_lambda1(sigma, D, n=600):
    """Slowest relaxation eigenvalue of Brown's 1-D Fokker-Planck operator
    (finite volume), as in the JAX package's test."""
    x = np.linspace(-1.0, 1.0, n + 1)
    xc = 0.5 * (x[1:] + x[:-1])
    dx = x[1] - x[0]
    a_f = D * (1.0 - x**2)
    ps = np.exp(sigma * xc**2)
    A = np.zeros((n, n))
    for i in range(1, n):
        c = a_f[i] * np.exp(sigma * x[i] ** 2) / dx
        A[i, i] -= c / ps[i] / dx
        A[i, i - 1] += c / ps[i - 1] / dx
        A[i - 1, i] += c / ps[i] / dx
        A[i - 1, i - 1] -= c / ps[i - 1] / dx
    ev = np.sort(np.linalg.eigvals(A).real)
    return -ev[-2]


def test_boltzmann_equilibrium_fast():
    delta, alpha, dt, span, B = 1.5, 0.3, 4e-13, 1.5e-9, 1024
    g = torch.Generator().manual_seed(11)
    m = torch.randn(B, 3, generator=g)
    m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    res = integrate_pulse(m.t().contiguous().unbind(0), torch.full((B,), span), torch.zeros(B),
                          _params(delta, alpha), _config(dt, span), seed=99, temperature=TEMP)
    assert not bool(res.failed.any())
    mz = res.m[2].double().numpy()
    xs = np.linspace(-1.0, 1.0, 2001)
    pdf = np.exp(delta * xs**2)
    cdf = sp_integrate.cumulative_trapezoid(pdf, xs, initial=0.0)
    cdf /= cdf[-1]
    ks = stats.kstest(mz, lambda v: np.interp(v, xs, cdf))
    assert ks.pvalue > 1e-5, f"m_z distribution rejects Boltzmann: {ks}"
    m2_theory = np.trapezoid(xs**2 * pdf, xs) / np.trapezoid(pdf, xs)
    assert abs(float((mz**2).mean()) - m2_theory) < 0.05


def test_neel_brown_switching_rate_fast():
    alpha, dt, B, sigma = 0.5, 4e-13, 512, 1.5
    D = alpha * GAMMA * KT / ((1 + alpha**2) * MU0 * MS * VOL)
    lam = _fp_lambda1(sigma, D, n=400)
    chunk = 1.0 / (10.0 * lam)
    params, cfg = _params(sigma, alpha), _config(dt, chunk)
    mx, my, mz = torch.zeros(B), torch.zeros(B), torch.ones(B)
    spans, cur = torch.full((B,), chunk), torch.zeros(B)
    means = []
    for k in range(6):
        res = integrate_pulse((mx, my, mz), spans, cur, params, cfg, seed=21 + k,
                              temperature=TEMP)
        mx, my, mz = res.m
        means.append(float(mz.mean()))
    means = np.asarray(means)
    ts = (np.arange(6) + 1) * chunk
    mask = (means > 0.05) & (means < 0.95)
    assert mask.sum() >= 3, means
    rate = -np.polyfit(ts[mask], np.log(means[mask]), 1)[0]
    assert 0.4 < rate / lam < 2.5, (rate, lam)


def test_jax_key_maps_to_a_seed():
    """A JAX key gives the port's seed (convert.seed_from_key), so a solver
    keyed by one draws reproducibly in the port."""
    from spintorque_tpu_torch.convert import key_from_seed, seed_from_key

    key = np.asarray(jax.random.PRNGKey(1234))
    assert key_from_seed(seed_from_key(key)).tolist() == key.tolist()
