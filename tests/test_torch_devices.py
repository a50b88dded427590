"""The port's device layer against the JAX package's: every analytic of
``devices/resistance.py`` and ``devices/skyrmion_ops.py`` and every
``Device`` method, in float64 on the same inputs (seeded numpy), at rtol
1e-12; the factory's registry, defaults and validation as in
``tests/unit/test_devices.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spintorque_tpu.devices as J
import spintorque_tpu_torch.devices as T
from spintorque_tpu_torch.constants import MU0

torch.set_num_threads(1)

RTOL = 1e-12
B = 64
TYPES = ("stt_mram", "sot_mram", "vcma_mram", "skyrmion", "skyrmion_track")


def _pair(device_type, overrides=None):
    jp = J.make_device_params(device_type, overrides, dtype=jnp.float64)
    tp = T.make_device_params(device_type, overrides, dtype=torch.float64, device="cpu")
    return jp, tp


def _close(got, ref, name=""):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for k, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{name}[{k}]")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0, err_msg=name)


def _unit(rng, n):
    m = rng.normal(size=(n, 3))
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def _voltages(rng):
    # zero, sub-uV, ohmic and tunneling fields, past breakdown, negative
    return np.concatenate([[0.0, 1e-13, 5e-7, 0.005, 0.5, 3.0, -1.0, 150.0],
                           rng.uniform(-2.5, 2.5, B - 8)])


def _currents(rng):
    return np.concatenate([[0.0, 1e-7, 1e5, -1e6, 1e8, 1e12], rng.uniform(-5e7, 5e7, B - 6)])


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _vcma_cases(rng):
    v = _voltages(rng)
    dur = rng.uniform(1e-12, 5e-9, B)
    yield "vcma_effective_anisotropy", (v,)
    yield "vcma_pulse_energy", (v, dur)
    yield "vcma_leakage_current", (v,)
    for temp in (300.0, 77.0):
        yield "vcma_switching_time", (v,), dict(temperature=temp)
    for temp in (300.0, 0.0):
        yield "vcma_switching_probability", (v, dur), dict(temperature=temp)


ANALYTICS = ["vcma", "sot", "energy_barrier", "resistance", "skyrmion"]


@pytest.mark.parametrize("group", ANALYTICS)
def test_analytics_match_jax(group):
    rng = np.random.default_rng(ANALYTICS.index(group))
    cases = []  # (name, args, kwargs, params type or (type, overrides))
    if group == "vcma":
        for name, args, *kw in _vcma_cases(rng):
            cases.append((name, args, kw[0] if kw else {}, "vcma_mram"))
    elif group == "sot":
        j, m = _currents(rng), _unit(rng, B)
        cases += [
            ("sot_torque_factors", (), {}, "sot_mram"),
            ("sot_switching_threshold", (), {}, "sot_mram"),
            ("sot_switching_time", (j,), {}, "sot_mram"),
            ("sot_switching_time", (j,), dict(temperature=400.0), "sot_mram"),
            ("sot_spin_torques", (j, m[:, 0], m[:, 1], m[:, 2]), {}, "sot_mram"),
            ("sot_spin_torques", (j, m[:, 0], m[:, 1], m[:, 2]),
             dict(current_direction=(0.3, -2.0, 0.5)), "sot_mram"),
        ]
    elif group == "energy_barrier":
        m = _unit(rng, B)
        for t in TYPES:
            cases.append(("energy_barrier", (t, m[:, 0], m[:, 1], m[:, 2]), {}, t))
        cases.append(("energy_barrier", ("vcma_mram", m[:, 0], m[:, 1], m[:, 2]),
                      dict(voltage=_voltages(rng)), "vcma_mram"))
    elif group == "resistance":
        m = _unit(rng, B)
        for t in TYPES:
            cases.append(("resistance", (t, m[:, 0], m[:, 1], m[:, 2]), {}, t))
        r, j = rng.uniform(500.0, 4e3, B), _currents(rng)
        cases.append(("pulse_energy", (j, rng.uniform(1e-12, 5e-9, B), r, 1e-14), {}, "stt_mram"))
    else:
        j = rng.normal(size=(B, 2)) * 1e11
        j[:3] = [[0.0, 0.0], [1e-13, 0.0], [0.0, -5e11]]
        y = np.concatenate([[1e-9, 9e-9, 195e-9, 100e-9], rng.uniform(0.0, 200e-9, B - 4)])
        for t in ("skyrmion", "stt_mram"):
            cases += [
                ("exchange_length", (), {}, t),
                ("magnus_coefficient", (), {}, t),
                ("skyrmion_hall_angle", (), {}, t),
                ("skyrmion_velocity", (j,), {}, t),
                ("skyrmion_velocity", (j,), dict(external_force=(1e-15, -2e-15)), t),
                ("skyrmion_energy", (), {}, t),
                ("skyrmion_stability", (y,), {}, t),
                ("skyrmion_stability", (y,), dict(temperature=900.0), t),
                ("skyrmion_resistance", (np.arange(6.0),), {}, t),
                ("skyrmion_resistance", (np.arange(6.0),),
                 dict(base_resistance=5e2, resistance_factor=0.3), t),
            ]
        # K = 0 takes sqrt(2A / (mu0 Ms^2)); the other branch stays finite.
        cases.append(("exchange_length", (), {}, ("skyrmion", {"uniaxial_anisotropy": 0.0})))

    for name, args, kw, ptype in cases:
        overrides = None
        if isinstance(ptype, tuple):
            ptype, overrides = ptype
        jp, tp = _pair(ptype, overrides)
        jargs = [a if isinstance(a, str) else _j(a) for a in args]
        targs = [a if isinstance(a, str) else _t(a) for a in args]
        kw_j = {k: (_j(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        kw_t = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        if name == "pulse_energy":
            ref, got = J.pulse_energy(*jargs), T.pulse_energy(*targs)
        elif name.startswith("skyrmion_") or name in ("exchange_length", "magnus_coefficient"):
            ref = getattr(J, name)(jp, *jargs, **kw_j)
            got = getattr(T, name)(tp, *targs, **kw_t)
        else:
            ref = getattr(J, name)(*jargs, params=jp, **kw_j)
            got = getattr(T, name)(*targs, params=tp, **kw_t)
        _close(got, ref, f"{name} {ptype} {kw}")


def test_python_numbers_become_tensors_of_the_params():
    """Scalars as the JAX tests pass them: Python floats for voltage,
    current and magnetization."""
    _, tp = _pair("vcma_mram")
    for out in (T.vcma_effective_anisotropy(1.0, tp), T.vcma_pulse_energy(1.0, 1e-9, tp),
                T.vcma_leakage_current(1.0, tp), T.vcma_switching_time(0.0, tp),
                T.vcma_switching_probability(2.0, 1e-9, tp),
                T.energy_barrier("vcma_mram", 0.0, 0.0, 1.0, tp, voltage=1.0)):
        assert out.dtype == torch.float64 and out.device.type == "cpu"
    assert float(T.vcma_switching_time(0.0, tp)) == np.inf
    assert float(T.vcma_switching_time(100.0, tp)) == pytest.approx(1e-12, rel=1e-5)
    _, sp = _pair("sot_mram")
    (dlx, _, dlz), (_, fly, _) = T.sot_spin_torques(1e10, 0.0, 0.0, 1.0, sp)
    assert float(dlx) > 0 and abs(float(dlz)) < 1e-6 and float(fly) > 0


@pytest.mark.parametrize("device_type", TYPES)
def test_device_methods_match_jax(device_type):
    rng = np.random.default_rng(TYPES.index(device_type) + 10)
    overrides = {"damping": 0.02}
    jd = J.DeviceFactory().create_device(device_type, dict(overrides), dtype=jnp.float64)
    td = T.DeviceFactory().create_device(device_type, dict(overrides), dtype=torch.float64,
                                         device="cpu")
    assert td.device_type == jd.device_type == device_type
    m = _unit(rng, B)
    h = rng.normal(size=(B, 3)) * 1e5
    _close(td.compute_resistance(m), jd.compute_resistance(m), "resistance (B, 3)")
    _close(td.compute_resistance(m[0]), jd.compute_resistance(m[0]), "resistance (3,)")
    _close(td.compute_effective_field(m, h), jd.compute_effective_field(m, h), "field (B, 3)")
    _close(td.compute_effective_field(m[3], np.zeros(3)),
           jd.compute_effective_field(m[3], np.zeros(3)), "field (3,)")
    j, dur = _currents(rng), rng.uniform(1e-12, 5e-9, B)
    _close(td.compute_power_consumption(j, dur, m), jd.compute_power_consumption(j, dur, m),
           "power")
    _close(td.compute_power_consumption(1e6, 1e-9, m[0]),
           jd.compute_power_consumption(1e6, 1e-9, m[0]), "power, scalars")
    raw = 3.0 * m
    np.testing.assert_array_equal(td.validate_magnetization(raw), jd.validate_magnetization(raw))
    for bad in (np.zeros(3), np.ones(2)):
        with pytest.raises(ValueError):
            td.validate_magnetization(bad)
    got, ref = td.get_switching_threshold(), jd.get_switching_threshold()
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=RTOL)
    got, ref = td.get_device_info(), jd.get_device_info()
    assert got.keys() == ref.keys() and got["device_type"] == ref["device_type"]
    for k in ("volume", "thickness", "saturation_magnetization"):
        assert got[k] == ref[k]
    assert repr(td) == repr(jd)
    assert td.get_parameter("damping") == jd.get_parameter("damping") == 0.02
    for d in (td, jd):
        d.set_parameter("damping", 0.03)
        d.set_parameter("temperature", 350.0)  # informational, no field
    assert td.params.damping.dtype == torch.float64 and td.params.damping.device.type == "cpu"
    assert float(td.params.damping) == float(np.asarray(jd.params.damping)) == 0.03
    assert td.get_parameter("temperature") == 350.0
    _close(td.compute_effective_field(m, h), jd.compute_effective_field(m, h), "after set")


def test_factory_registry_and_defaults():
    f = T.DeviceFactory()
    assert f.get_available_devices() == J.DeviceFactory().get_available_devices()
    assert set(f.get_available_devices()) >= set(TYPES)
    for t in f.get_available_devices():
        d = f.create_default_device(t, device="cpu")
        assert d.device_type == t
        assert d.params.volume.dtype == torch.float32
        got, ref = f.get_default_parameters(t), J.device_factory.get_default_parameters(t)
        assert got.keys() == ref.keys()
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
        assert f.get_device_info(t)["name"] == t
    assert f.create_device("STT_MRAM", device="cpu").device_type == "stt_mram"
    with pytest.raises(ValueError):
        f.create_device("nonexistent", {}, device="cpu")
    with pytest.raises(ValueError):
        f.get_device_info("nonexistent")
    assert T.device_factory.get_default_parameters("sot_mram")["spin_hall_angle"] == 0.2
    d = T.create_device("stt_mram", damping=0.05, device="cpu")
    assert d.get_parameter("damping") == 0.05 and float(d.params.damping) == pytest.approx(0.05)


def test_factory_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.create_device("stt_mram")


def test_parameter_validation():
    for bad in ({"damping": 2.0}, {"volume": -1.0}, {"saturation_magnetization": 0.0}):
        with pytest.raises(ValueError):
            T.create_device("stt_mram", bad, device="cpu")
    with pytest.raises(ValueError):
        T.create_device("stt_mram", {"polarization": 1.5}, device="cpu")
    T.create_device("sot_mram", {"polarization": 1.5}, device="cpu")  # STT only
    with pytest.raises(ValueError):
        T.make_device_params("stt_mram", {"bogus_parameter": 1.0}, device="cpu")


def test_stt_resistance_and_field_values():
    d = T.create_device("stt_mram", device="cpu", dtype=torch.float64)
    r = d.compute_resistance(np.array([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0]]))
    np.testing.assert_allclose(r.numpy(), [1e3, 2e3, 1.5e3], rtol=1e-12)
    h = d.compute_effective_field(np.array([0.0, 0.0, 1.0]), np.zeros(3))
    np.testing.assert_allclose(float(h[2]), 2 * 1.2e6 / (MU0 * 800e3) - 800e3, rtol=1e-12)
