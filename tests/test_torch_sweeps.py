"""The port's research sweeps against the JAX package's.

Counterpart of tests/unit/test_research_sweeps.py: the physics checks of
the switching diagram and the Neel-Brown ladder at small size on the CPU,
the ladder's validation and ``failed_fraction``, parity with the JAX sweeps
(``use_pallas=False``, run op by op) at temperature 0 at the float32
tolerance of tests/test_torch_integrator.py (rtol = atol = 2e-6, p_switch
identical), and a sweep cut into two gloo ranks equal to the unsharded one
bit for bit, thermal noise included (each rank draws its rows of the
unsharded Philox stream).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.research.sweeps import parameter_ladder_sweep as jax_ladder
from spintorque_tpu.research.sweeps import switching_probability_diagram as jax_diagram
from spintorque_tpu_torch.constants import KB_SOLVER, MU0
from spintorque_tpu_torch.parallel import make_mesh, spawn_ranks
from spintorque_tpu_torch.physics import LLGSParams
from spintorque_tpu_torch.research import parameter_ladder_sweep, switching_probability_diagram

torch.set_num_threads(1)

VALUES = dict(saturation_magnetization=800e3, damping=0.05, uniaxial_anisotropy=1.2e6,
              volume=1e-22, polarization=0.7, easy_axis=[0.0, 0.0, 1.0])


def _params(**over):
    vals = {**VALUES, **over}
    return LLGSParams(**{k: torch.tensor(v, dtype=torch.float32) for k, v in vals.items()})


def _jax_params(**over):
    vals = {**VALUES, **over}
    return JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in vals.items()})


def test_switching_diagram_physics():
    out = switching_probability_diagram(
        _params(), currents=[-2e7, 0.0, 2e7], durations=[2e-10, 1e-9], n_ensemble=16,
        temperature=300.0, max_substeps=1024, seed=1, device="cpu",
    )
    p = out["p_switch"].numpy()
    assert p.shape == (3, 2)
    assert np.all((p >= 0) & (p <= 1))
    # Strong negative J switches -z -> +z; zero and anti-switching J do not.
    assert np.all(p[0] > 0.9), p
    assert np.all(p[1] < 0.1), p
    assert np.all(p[2] < 0.1), p
    assert np.all(np.isfinite(out["final_mz"].numpy()))
    assert out["final_mz"].shape == (3 * 2 * 16,)


def test_parameter_ladder_barrier_dependence():
    """Zero-drive thermal retention along a K_u ladder: the flip
    probability over 4 ns falls with the barrier Delta = (K_u - mu0 Ms^2/2)
    V / kT (the JAX package's calibration: p = [0.42, 0.31, 0.016, 0.0] at
    Delta = [1, 3, 8, 20])."""
    ms, vol, temp = 800e3, 1e-24, 300.0
    deltas = np.array([1.0, 3.0, 8.0, 20.0])
    k_ladder = 0.5 * MU0 * ms**2 + deltas * KB_SOLVER * temp / vol
    out = parameter_ladder_sweep(
        _params(damping=0.5, volume=vol), {"uniaxial_anisotropy": k_ladder},
        current=0.0, duration=4e-9, n_ensemble=64, temperature=temp, seed=5, method="heun",
        device="cpu",
    )
    p = out["p_switch"].numpy()
    assert p.shape == (4,)
    assert p[0] > 0.25, p
    assert p[1] > p[2] + 0.1, p
    assert p[3] < 0.02, p
    np.testing.assert_array_equal(out["uniaxial_anisotropy"].numpy(),
                                  np.asarray(k_ladder, np.float32))


def test_parameter_ladder_validates():
    with pytest.raises(ValueError, match="ladder"):
        parameter_ladder_sweep(_params(), {"damping": [0.01, 0.02], "volume": [1e-22]},
                               current=-1e7, duration=2e-10, n_ensemble=4, device="cpu")
    with pytest.raises(ValueError, match="at least"):
        parameter_ladder_sweep(_params(), {}, current=-1e7, duration=2e-10, device="cpu")


def test_sweeps_report_failed_fraction():
    """Failed trajectories leave the switching denominator and show in
    ``failed_fraction``; a point whose whole ensemble failed reports nan (a
    small current in float32: the reference's freeze, as in JAX)."""
    out = switching_probability_diagram(
        _params(), currents=[-2e7, 1e6], durations=[2e-10], n_ensemble=8, temperature=300.0,
        max_substeps=512, seed=1, device="cpu",
    )
    assert out["failed_fraction"].shape == (2, 1)
    assert float(out["failed_fraction"][0, 0]) == 0.0
    assert float(out["failed_fraction"][1, 0]) == 1.0 and np.isnan(float(out["p_switch"][1, 0]))
    lad = parameter_ladder_sweep(_params(), {"damping": [0.05, 0.1]}, current=-2e7,
                                 duration=2e-10, n_ensemble=8, temperature=300.0, seed=2,
                                 device="cpu")
    assert lad["failed_fraction"].shape == (2,)


def test_sweeps_default_to_the_card():
    for fn in (switching_probability_diagram, parameter_ladder_sweep):
        assert inspect.signature(fn).parameters["device"].default is None  # "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            switching_probability_diagram(_params(), [-2e7], [2e-10], n_ensemble=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parameter_ladder_sweep(_params(), {"damping": [0.1]}, current=0.0, duration=1e-10)


def test_diagram_and_ladder_match_jax_at_zero_temperature():
    kw = dict(currents=[-2e7, -5e6, 2e7], durations=[2e-10, 4e-10], n_ensemble=4,
              temperature=0.0, max_substeps=512)
    with jax.disable_jit():
        ref = jax_diagram(_jax_params(), use_pallas=False, **kw)
        ref_lad = jax_ladder(_jax_params(), {"damping": jnp.asarray([0.02, 0.05, 0.1])},
                             current=-1e7, duration=3e-10, n_ensemble=4, temperature=0.0)
    out = switching_probability_diagram(_params(), device="cpu", **kw)
    np.testing.assert_array_equal(out["p_switch"].numpy(), np.asarray(ref["p_switch"]))
    np.testing.assert_allclose(out["final_mz"].numpy(), np.asarray(ref["final_mz"]),
                               rtol=2e-6, atol=2e-6)
    lad = parameter_ladder_sweep(_params(), {"damping": [0.02, 0.05, 0.1]}, current=-1e7,
                                 duration=3e-10, n_ensemble=4, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(lad["p_switch"].numpy(), np.asarray(ref_lad["p_switch"]))
    np.testing.assert_array_equal(lad["failed_fraction"].numpy(),
                                  np.asarray(ref_lad["failed_fraction"]))


DIAGRAM = dict(currents=[-2e7, -6e6], durations=[2e-10, 5e-10], n_ensemble=16,
               temperature=300.0, max_substeps=1024, seed=3)
# Zero drive over a barrier ladder of Delta = 1, 3 (the retention setup
# above), where the thermal field alone decides each trajectory.
LADDER = dict(vary={"uniaxial_anisotropy": 0.5 * MU0 * 800e3**2
                    + np.array([1.0, 3.0]) * KB_SOLVER * 300.0 / 1e-24},
              current=0.0, duration=1e-9, n_ensemble=32, temperature=300.0, seed=4)


def _sweeps_rank():
    mesh = make_mesh(device="cpu")
    return (switching_probability_diagram(_params(), mesh=mesh, device="cpu", **DIAGRAM),
            parameter_ladder_sweep(_params(damping=0.5, volume=1e-24), mesh=mesh,
                                   device="cpu", **LADDER))


def test_sharded_sweeps_equal_unsharded():
    ref = switching_probability_diagram(_params(), device="cpu", **DIAGRAM)
    ref_lad = parameter_ladder_sweep(_params(damping=0.5, volume=1e-24), device="cpu", **LADDER)
    assert float(ref["final_mz"].std()) > 0  # the noise moved the trajectories
    assert 0.0 < float(ref_lad["p_switch"][0]) < 1.0
    for diagram, ladder in spawn_ranks(_sweeps_rank, 2, timeout=120.0):
        for k in ("p_switch", "failed_fraction", "final_mz"):
            assert torch.equal(diagram[k], ref[k]), k
        for k in ("p_switch", "failed_fraction"):
            assert torch.equal(ladder[k], ref_lad[k]), k
