"""spintorque_tpu_torch.physics.energy_landscape and .vector_ops against the
JAX package's.

The same inputs go through both packages, float64. Tolerances: energies,
surfaces, barriers and the effective field (autograd against jax.grad) at
rtol 1e-12, atol 1e-12 of the largest magnitude; the grid search's minima
as a set (to its dedupe's dot > 0.999: near-tied grid points may swap);
the phase diagram exactly (the same bistable grid); the
batched vector ops at rtol 1e-12. The JAX package's own tests of the
module (tests/unit/test_energy_landscape.py) are ported with their
tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spintorque_tpu.physics.vector_ops as JV
from spintorque_tpu.physics import EnergyLandscape as JLandscape
from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu_torch.constants import MU0
from spintorque_tpu_torch.physics import (
    EnergyLandscape,
    LLGSParams,
    batch_anisotropy_field,
    batch_cross,
    batch_demag_field_thin_film,
    batch_dot,
    batch_magnetic_energy,
    batch_normalize,
    batch_tmr_resistance,
)
from spintorque_tpu_torch.physics.vector_ops import benchmark_batch_ops

torch.set_num_threads(1)

VALS = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
            volume=1e-23, polarization=0.7)


def _pair(axis=(0.0, 0.0, 1.0)):
    return (JParams(**VALS, easy_axis=jnp.asarray(axis, jnp.float64)),
            LLGSParams(**{k: torch.tensor(v, dtype=torch.float64) for k, v in VALS.items()},
                       easy_axis=torch.tensor(axis, dtype=torch.float64)))


JP, TP = _pair()


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("include_demag", [True, False])
@pytest.mark.parametrize("axis", [(0.0, 0.0, 1.0), (0.3, 0.4, 0.866)])
def test_landscape_matches_jax(include_demag, axis):
    jp, tp = _pair(axis)
    ours, theirs = EnergyLandscape(tp, include_demag), JLandscape(jp, include_demag)
    assert ours.params.volume.dtype == torch.float64
    rng = np.random.default_rng(0)
    m = rng.normal(size=(32, 3))
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    field = (1e4, -3e4, 2e5)
    _close(ours.energy(m, field), theirs.energy(m, field))
    _close(ours.effective_field(m, field), theirs.effective_field(m, field))
    a, b = ours.energy_surface(30, 60, field), theirs.energy_surface(30, 60, field)
    for k in ("theta", "phi", "energy"):
        _close(a[k], b[k])
    np.testing.assert_allclose(ours.energy_barrier([0, 0, 1.0], [1.0, 0, 0], 100),
                               theirs.energy_barrier([0, 0, 1.0], [1.0, 0, 0], 100), rtol=1e-12)
    # The same minima; grid points that tie to rounding may pick another
    # neighbour or order: matched as a set, to the dedupe's dot > 0.999.
    a, b = ours.find_stable_states(61, 120), theirs.find_stable_states(61, 120)
    assert a.shape == b.shape
    assert (np.max(a @ b.T, axis=1) > 0.999).all() and (np.max(b @ a.T, axis=1) > 0.999).all()
    np.testing.assert_allclose(ours.thermal_stability_factor(250.0),
                               theirs.thermal_stability_factor(250.0), rtol=1e-12)
    h_k = 2 * 1.2e6 / (MU0 * 800e3)
    a = ours.switching_phase_diagram((0.0, 2.0 * h_k), n_fields=12, n_angles=9)
    b = theirs.switching_phase_diagram((0.0, 2.0 * h_k), n_fields=12, n_angles=9)
    np.testing.assert_array_equal(a["bistable"].numpy(), np.asarray(b["bistable"]))
    _close(a["fields"], b["fields"])
    _close(a["angles"], b["angles"])
    np.testing.assert_allclose(float(a["anisotropy_field"]), float(b["anisotropy_field"]),
                               rtol=1e-12)


def test_stable_states_are_poles():
    states = EnergyLandscape(TP, include_demag=False).find_stable_states()
    assert len(states) == 2
    np.testing.assert_allclose(np.abs(np.sort(states[:, 2])), 1.0, atol=1e-2)


def test_energy_barrier_equals_KuV():
    el = EnergyLandscape(TP, include_demag=False)
    barrier = el.energy_barrier([0, 0, 1.0], [1.0, 0, 0], n_points=720)
    np.testing.assert_allclose(barrier, 1.2e6 * 1e-23, rtol=1e-4)


def test_effective_field_matches_analytic():
    el = EnergyLandscape(TP, include_demag=True)
    h = el.effective_field(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))
    h_k = 2 * 1.2e6 / (MU0 * 800e3)
    np.testing.assert_allclose(float(h[2]), h_k - 800e3, rtol=1e-10)


def test_thermal_stability_factor():
    delta = EnergyLandscape(TP).thermal_stability_factor(300.0)
    np.testing.assert_allclose(delta, 1.2e6 * 1e-23 / (1.380649e-23 * 300), rtol=1e-10)


def test_phase_diagram_bistability_vanishes_at_high_field():
    el = EnergyLandscape(TP, include_demag=False)
    h_k = 2 * 1.2e6 / (MU0 * 800e3)
    grid = el.switching_phase_diagram((0.0, 2.0 * h_k), n_fields=20, n_angles=10)["bistable"]
    assert grid[0].all()  # zero field: always bistable
    assert not grid[-1].any()  # 2 H_k: monostable at every angle


def test_batch_ops():
    a = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]])
    b = torch.tensor([[0, 1.0, 0], [0, 0, 2.0]])
    np.testing.assert_allclose(batch_cross(a, b).numpy(), [[0, 0, 1], [2, 0, 0]])
    np.testing.assert_allclose(batch_normalize(torch.tensor([[3.0, 0, 4.0]])).numpy(),
                               [[0.6, 0, 0.8]])
    r = batch_tmr_resistance(torch.tensor([[0, 0, 1.0], [0, 0, -1.0]]), [0, 0, 1.0], 1e3, 2e3)
    np.testing.assert_allclose(r.numpy(), [1e3, 2e3])


def test_batch_ops_match_jax():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(4, 5, 3))
    h = rng.normal(size=(4, 5, 3)) * 1e4
    axis = [0.2, -0.4, 0.9]
    t = torch.from_numpy
    _close(batch_cross(t(m), t(h)), JV.batch_cross(m, h))
    _close(batch_dot(t(m), t(h)), JV.batch_dot(m, h))
    _close(batch_normalize(t(m)), JV.batch_normalize(m))
    _close(batch_magnetic_energy(t(m), t(h), 8e5, 1e6, 1e-24, axis),
           JV.batch_magnetic_energy(m, h, 8e5, 1e6, 1e-24, jnp.asarray(axis)))
    _close(batch_tmr_resistance(t(m), axis, 1e3, 2.5e3),
           JV.batch_tmr_resistance(m, jnp.asarray(axis), 1e3, 2.5e3))
    _close(batch_anisotropy_field(t(m), 8e5, 1e6, axis),
           JV.batch_anisotropy_field(m, 8e5, 1e6, jnp.asarray(axis)))
    _close(batch_demag_field_thin_film(t(m), 8e5), JV.batch_demag_field_thin_film(m, 8e5))
    out = benchmark_batch_ops(batch_size=64, iters=3, device="cpu")
    assert out["device"] == "cpu" and out["ops_per_s"] > 0
