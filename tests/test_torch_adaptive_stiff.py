"""The JAX package's tests of its adaptive integrators
(tests/unit/test_adaptive.py), ported to spintorque_tpu_torch, with their
tolerances: dense fixed-step RK4 on the same RHS (rtol 1e-5, atol 1e-6),
scipy's Radau on the same RHS as the golden reference (rtol = atol =
1e-5), the method names, the stiff step counts, and Radau against RK45 on
per-env parameters (atol 3e-5). The golden's RHS is an independent numpy
form of the adaptive RHS, where the JAX test calls the jitted JAX one.
The method-name check integrates 5e-11 s where the JAX test takes 2e-10
s: the same comparison at a quarter of the cost.
"""

import numpy as np
import pytest
import torch

from spintorque_tpu_torch.constants import GAMMA, MU0
from spintorque_tpu_torch.physics import LLGSParams, integrate_adaptive
from spintorque_tpu_torch.physics.adaptive import _fvec, _rhs_invariants

torch.set_num_threads(1)

BASE = dict(saturation_magnetization=800e3, damping=0.05, uniaxial_anisotropy=1.2e6,
            volume=1e-23, polarization=0.7)
SMALL_CURRENT = 1e-11  # where the adaptive RHS is not absurdly stiff


def _params(**over):
    vals = dict(BASE, **over)
    return LLGSParams(**{k: torch.as_tensor(np.asarray(v, float)) for k, v in vals.items()},
                      easy_axis=torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))


TP = _params()


def _starts(B, seed):
    m = np.random.default_rng(seed).normal(size=(B, 3))
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def _m(res):
    return np.stack([np.asarray(c) for c in res.m], axis=-1)


def _fixed_rk4_same_rhs(m0, span, current, n_steps=4000):
    """Dense fixed-step RK4 on the SAME RHS, as the accuracy reference."""
    mx, my, mz = m0
    dt = span / n_steps
    c = _rhs_invariants(current, TP)

    def f(a, b, d):
        n = torch.sqrt(a * a + b * b + d * d)
        return _fvec(torch.stack((a / n, b / n, d / n), -1), c).unbind(-1)

    m = (mx, my, mz)
    for _ in range(n_steps):
        a, b, d = m
        k1 = f(a, b, d)
        k2 = f(a + dt / 2 * k1[0], b + dt / 2 * k1[1], d + dt / 2 * k1[2])
        k3 = f(a + dt / 2 * k2[0], b + dt / 2 * k2[1], d + dt / 2 * k2[2])
        k4 = f(a + dt * k3[0], b + dt * k3[1], d + dt * k3[2])
        out = tuple(m[j] + dt / 6 * (k1[j] + 2 * k2[j] + 2 * k3[j] + k4[j]) for j in range(3))
        n = torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2)
        m = (out[0] / n, out[1] / n, out[2] / n)
    return m


def test_adaptive_matches_dense_fixed_step():
    B = 8
    m = torch.from_numpy(_starts(B, 0))
    m0 = m.unbind(-1)
    span = 2e-10
    cur = torch.full((B,), SMALL_CURRENT, dtype=torch.float64)
    ada = integrate_adaptive(m0, torch.full((B,), span, dtype=torch.float64), cur, TP,
                             rtol=1e-8, atol=1e-11)
    assert bool(ada.success.all()), (ada.n_steps, ada.n_rejected)
    ref = _fixed_rk4_same_rhs(m0, span, cur)
    for c in range(3):
        np.testing.assert_allclose(ada.m[c].numpy(), ref[c].numpy(), rtol=1e-5, atol=1e-6)


def test_adaptive_step_control_responds_to_tolerance():
    B = 4
    m = torch.tensor([[0.5, 0.1, 0.86]], dtype=torch.float64).repeat(B, 1)
    m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    spans = torch.full((B,), 5e-10, dtype=torch.float64)
    cur = torch.zeros(B, dtype=torch.float64)
    loose = integrate_adaptive(m.unbind(-1), spans, cur, TP, rtol=1e-4, atol=1e-7)
    tight = integrate_adaptive(m.unbind(-1), spans, cur, TP, rtol=1e-10, atol=1e-13)
    assert bool(loose.success.all()) and bool(tight.success.all())
    assert int(tight.n_steps[0]) > int(loose.n_steps[0])


def _np_rhs(m, current, p=BASE):
    """The adaptive RHS in numpy, written from its definition: explicit
    Gilbert damping, thin-film demag, the placeholder exchange field,
    Slonczewski torque with p = z and its 0.1 field-like part."""
    ms, alpha = p["saturation_magnetization"], p["damping"]
    z = np.array([0.0, 0.0, 1.0])
    h = ((2.0 * p["uniaxial_anisotropy"] / (MU0 * ms)) * m[2] * z - ms * m[2] * z
         + (2.0 * 20e-12 / (MU0 * ms)) * 0.1 * m)
    g = -GAMMA * np.cross(m, h)
    d = g + alpha * np.cross(m, g)
    beta = p["polarization"] * GAMMA / (2.0 * ms * p["volume"])
    coeff = beta * current if abs(current) > 1e-12 else 0.0
    u = np.cross(m, z)
    return d + coeff * np.cross(m, u) + 0.1 * coeff * u


def _scipy_radau_same_rhs(m0_single, span, current, rtol=1e-9, atol=1e-12):
    """scipy's Radau on the same RHS, per-evaluation renormalization
    included: the independent golden reference."""
    from scipy.integrate import solve_ivp

    def rhs(t, y):
        n = np.linalg.norm(y)
        return _np_rhs(y / n if n > 1e-12 else np.array([0.0, 0.0, 1.0]), current)

    sol = solve_ivp(rhs, (0.0, span), np.asarray(m0_single, float), method="Radau",
                    rtol=rtol, atol=atol)
    assert sol.success
    y = sol.y[:, -1]
    return y / np.linalg.norm(y)


def test_numpy_rhs_is_the_ports():
    m = _starts(6, 9)
    for cur in (0.0, SMALL_CURRENT):
        want = np.stack([_np_rhs(v, cur) for v in m])
        got = _fvec(torch.from_numpy(m), _rhs_invariants(cur, TP)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_radau_matches_scipy_radau():
    starts = np.array([[0.3, 0.1, 0.949], [0.0, 0.6, -0.8], [0.9, -0.3, 0.316],
                       [-0.5, 0.5, 0.707]])
    starts = starts / np.linalg.norm(starts, axis=-1, keepdims=True)
    span = 1e-9
    res = integrate_adaptive(tuple(torch.from_numpy(starts[:, c].copy()) for c in range(3)),
                             torch.full((4,), span, dtype=torch.float64),
                             torch.full((4,), SMALL_CURRENT, dtype=torch.float64), TP,
                             rtol=1e-8, atol=1e-11, dt_max=5e-11, method="radau")
    assert bool(res.success.all()), (res.n_steps, res.n_rejected)
    ours = _m(res)
    for b in range(4):
        golden = _scipy_radau_same_rhs(starts[b], span, SMALL_CURRENT)
        np.testing.assert_allclose(ours[b], golden, rtol=1e-5, atol=1e-5)


def test_implicit_method_names_and_validation():
    m0 = (torch.tensor([0.4], dtype=torch.float64), torch.tensor([0.2], dtype=torch.float64),
          torch.tensor([0.894], dtype=torch.float64))
    spans = torch.tensor([5e-11], dtype=torch.float64)
    cur = torch.zeros(1, dtype=torch.float64)
    outs = [_m(integrate_adaptive(m0, spans, cur, TP, rtol=1e-7, atol=1e-10, method=meth))
            for meth in ("radau", "BDF", "lsoda")]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    mid = _m(integrate_adaptive(m0, spans, cur, TP, rtol=1e-7, atol=1e-10, method="midpoint"))
    np.testing.assert_allclose(mid, outs[0], atol=2e-4)
    with pytest.raises(ValueError, match="unknown method"):
        integrate_adaptive(m0, spans, cur, TP, method="rk23")


def _stiff():
    return _params(damping=0.5)


def test_implicit_takes_far_fewer_steps_when_stiff():
    stiff = _stiff()
    m0 = (torch.tensor([0.6], dtype=torch.float64), torch.tensor([0.0], dtype=torch.float64),
          torch.tensor([0.8], dtype=torch.float64))
    spans = torch.tensor([5e-9], dtype=torch.float64)
    cur = torch.zeros(1, dtype=torch.float64)
    kw = dict(rtol=1e-6, atol=1e-9, dt_max=5e-10)
    exp = integrate_adaptive(m0, spans, cur, stiff, method="rk45", **kw)
    assert bool(exp.success.all())
    np.testing.assert_allclose(float(exp.m[2][0]), 1.0, atol=1e-6)
    for meth in ("radau", "midpoint"):
        imp = integrate_adaptive(m0, spans, cur, stiff, method=meth, **kw)
        assert bool(imp.success.all())
        np.testing.assert_allclose(float(imp.m[2][0]), 1.0, atol=1e-6)
        assert int(imp.n_steps[0]) * 2 < int(exp.n_steps[0]), (
            meth, int(imp.n_steps[0]), int(exp.n_steps[0]))


def test_radau_matches_rk45_on_randomized_per_env_params():
    rng = np.random.default_rng(5)
    B = 8
    damping = rng.uniform(0.02, 0.4, B)
    k_u = rng.uniform(4e5, 1.6e6, B)
    tp = _params(damping=damping, uniaxial_anisotropy=k_u)
    m = rng.normal(size=(B, 3))
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    m0 = tuple(torch.from_numpy(m[:, c].copy()) for c in range(3))
    spans = torch.full((B,), 3e-10, dtype=torch.float64)
    cur = torch.from_numpy(rng.uniform(-2e-11, 2e-11, B))
    rad = integrate_adaptive(m0, spans, cur, tp, rtol=1e-7, atol=1e-10, method="radau")
    exp = integrate_adaptive(m0, spans, cur, tp, rtol=1e-7, atol=1e-10, method="rk45")
    assert bool(rad.success.all()) and bool(exp.success.all())
    np.testing.assert_allclose(_m(rad), _m(exp), atol=3e-5)
