"""spintorque_tpu_torch.physics.llgs against spintorque_tpu.physics.llgs.

The same numpy inputs (seeded) go through both packages on the CPU.
Tolerances: float64 at rtol 1e-12 and float32 at rtol 1e-6, each with an
atol of rtol times the largest magnitude of the reference output, because
the cross products cancel to near zero where a relative bound means nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.physics import llgs as jllgs
from spintorque_tpu_torch.physics import llgs as tllgs

torch.set_num_threads(1)

B = 64
RTOL = {np.float64: 1e-12, np.float32: 1e-6}
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _inputs(dtype, per_env_axis, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(3, B)) * rng.uniform(0.5, 2.0, size=B)
    params = dict(
        saturation_magnetization=rng.uniform(4e5, 1.2e6, B),
        damping=rng.uniform(0.005, 0.05, B),
        uniaxial_anisotropy=rng.uniform(3e5, 2e6, B),
        volume=rng.uniform(5e-24, 5e-23, B),
        polarization=np.float64(0.7),
    )
    axis = rng.normal(size=(B, 3)) if per_env_axis else np.array([0.6, 0.0, 0.8])
    params["easy_axis"] = axis
    current = rng.uniform(-1e6, 1e6, B)
    current[:4] = [0.0, 1e-13, -1e-13, 2e-12]  # around the |J| > 1e-12 gate
    field = rng.normal(size=(3, B)) * 1e4
    cast = {k: np.asarray(v, dtype) for k, v in params.items()}
    return m.astype(dtype), cast, current.astype(dtype), field.astype(dtype)


def _both(dtype, params):
    jp = jllgs.LLGSParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tp = tllgs.LLGSParams(**{k: torch.tensor(v) for k, v in params.items()})
    return jp, tp


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(port, ref, dtype):
    rtol = RTOL[dtype]
    for p, r in zip(port, ref):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        r = np.asarray(r)
        assert p.dtype == r.dtype, (p.dtype, r.dtype)
        atol = rtol * max(float(np.abs(r).max()), np.finfo(dtype).tiny)
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol)


CASES = [(d, a) for d in (np.float64, np.float32) for a in (False, True)]
IDS = [f"{np.dtype(d).name}-{'per_env' if a else 'scalar'}_axis" for d, a in CASES]


@pytest.mark.parametrize("dtype,per_env_axis", CASES, ids=IDS)
def test_normalized_easy_axis(dtype, per_env_axis):
    _, params, _, _ = _inputs(dtype, per_env_axis)
    jp, tp = _both(dtype, params)
    _close(tp.normalized_easy_axis(), jp.normalized_easy_axis(), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
def test_cross(dtype):
    m, _, _, f = _inputs(dtype, False)
    _close(tllgs.cross(*map(_t, m), *map(_t, f)), jllgs.cross(*m, *f), dtype)


@pytest.mark.parametrize("dtype,per_env_axis", CASES, ids=IDS)
def test_effective_field(dtype, per_env_axis):
    m, params, _, f = _inputs(dtype, per_env_axis)
    jp, tp = _both(dtype, params)
    _close(tllgs.effective_field(*map(_t, m), tp), jllgs.effective_field(*m, jp), dtype)
    applied, thermal = f, f[::-1] * 0.5
    _close(
        tllgs.effective_field(*map(_t, m), tp, tuple(map(_t, applied)), tuple(map(_t, thermal))),
        jllgs.effective_field(*m, jp, tuple(applied), tuple(thermal)),
        dtype,
    )


@pytest.mark.parametrize("dtype,per_env_axis", CASES, ids=IDS)
def test_dmdt(dtype, per_env_axis):
    m, params, current, f = _inputs(dtype, per_env_axis)
    jp, tp = _both(dtype, params)
    _close(
        tllgs.dmdt(*map(_t, m), _t(current), tp),
        jllgs.dmdt(*m, current, jp),
        dtype,
    )
    _close(
        tllgs.dmdt(*map(_t, m), _t(current), tp, h_thermal=tuple(map(_t, f))),
        jllgs.dmdt(*m, current, jp, h_thermal=tuple(f)),
        dtype,
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
def test_thermal_field_strength(dtype):
    _, params, _, _ = _inputs(dtype, False)
    jp, tp = _both(dtype, params)
    temperature = np.asarray(np.linspace(0.0, 600.0, B), dtype)
    _close(
        [tllgs.thermal_field_strength(tp, _t(temperature))],
        [jllgs.thermal_field_strength(jp, temperature)],
        dtype,
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
def test_normalize_with_fallback(dtype):
    m, _, _, _ = _inputs(dtype, False)
    m[:, :6] = np.array([
        [0.0, 0.0, 0.0], [np.nan, 1.0, 1.0], [np.inf, 0.0, 0.0],
        [1e-13, 0.0, 0.0], [0.0, -np.inf, 2.0], [3.0, 4.0, 0.0],
    ], dtype).T
    port = tllgs.normalize_with_fallback(*map(_t, m))
    _close(port, jllgs.normalize_with_fallback(*m), dtype)
    # The fallback probes: zero, NaN, Inf and sub-threshold rows go to +z.
    out = np.stack([p.numpy() for p in port], -1)
    np.testing.assert_array_equal(out[:5], np.tile(np.array([0.0, 0.0, 1.0], dtype), (5, 1)))
    np.testing.assert_allclose(out[5], [0.6, 0.8, 0.0], rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype,per_env_axis", CASES, ids=IDS)
def test_energy_density(dtype, per_env_axis):
    m, params, _, f = _inputs(dtype, per_env_axis)
    jp, tp = _both(dtype, params)
    _close([tllgs.energy_density(*map(_t, m), tp)], [jllgs.energy_density(*m, jp)], dtype)
    _close(
        [tllgs.energy_density(*map(_t, m), tp, tuple(map(_t, f)))],
        [jllgs.energy_density(*m, jp, tuple(f))],
        dtype,
    )


def test_coefficients_match_dmdt():
    """The integrator's precomputed-coefficient path gives dmdt's bits."""
    m, params, current, f = _inputs(np.float32, True)
    _, tp = _both(np.float32, params)
    c = tllgs.coefficients(_t(current), tp)
    ref = tllgs.dmdt(*map(_t, m), _t(current), tp, h_thermal=tuple(map(_t, f)))
    got = tllgs.dmdt_from(*map(_t, m), c, h_thermal=tuple(map(_t, f)))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_params_to_keeps_plus_z_and_casts():
    _, params, _, _ = _inputs(np.float64, False)
    _, tp = _both(np.float64, params)
    tp = tllgs.LLGSParams(**{**{k: getattr(tp, k) for k in params}, "plus_z": False})
    t32 = tp.to(dtype=torch.float32)
    assert t32.plus_z is False
    assert all(getattr(t32, k).dtype == torch.float32 for k in params)
