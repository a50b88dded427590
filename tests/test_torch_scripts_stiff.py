"""The stiff-solver ladder of ``scripts/torch/bench_stiff_solvers.py``
against the JAX package.

``bench_stiff_solvers --device cpu --rtols 1e-6 --ref-rtol 1e-8`` takes,
for Radau, the midpoint and RK45, exactly the accepted and rejected steps
that ``spintorque_tpu.physics.integrate_adaptive`` (jitted, float64) takes
on the same case (alpha 0.5, m0 (0.6, 0, 0.8), 5e-11 s, atol = rtol x
1e-3, dt_max 5e-10), its Radau reference at 1e-8 included; the true
errors (each method's distance from the reference) match JAX's at rtol
1e-6 (float64 ops in another order: the jitted XLA loop fuses
multiply-adds). scipy's Radau runs the port's RHS at the first rtol and
succeeds. The recorded JAX ladder (docs/STIFF_SOLVER_STEPS.json, from
the JAX program at the same rtols) gives the same counts.
"""

import functools
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spintorque_tpu.physics import LLGSParams as JParams
from spintorque_tpu.physics import integrate_adaptive as jax_integrate_adaptive

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STIFF = dict(saturation_magnetization=800e3, damping=0.5, uniaxial_anisotropy=1.2e6,
             volume=1e-23, polarization=0.7)
M0 = (0.6, 0.0, 0.8)
SPAN = 5e-11


def _program():
    path = ROOT / "scripts" / "torch" / "bench_stiff_solvers.py"
    spec = importlib.util.spec_from_file_location("torch_script_bench_stiff_solvers", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _jax(method, rtol):
    """(final m, accepted, rejected) of the JAX package's solve of the case."""
    p = JParams(**{k: jnp.float64(v) for k, v in STIFF.items()},
                easy_axis=jnp.array([0.0, 0.0, 1.0], jnp.float64))
    r = jax_integrate_adaptive(tuple(jnp.asarray([c], jnp.float64) for c in M0),
                               jnp.asarray([SPAN], jnp.float64), jnp.zeros((1,), jnp.float64), p,
                               rtol=rtol, atol=rtol * 1e-3, dt_max=5e-10, max_steps=2_000_000,
                               method=method)
    assert bool(r.success.all()), method
    return np.array([float(c[0]) for c in r.m]), int(r.n_steps[0]), int(r.n_rejected[0])


@pytest.fixture(scope="module")
def ladder():
    return _program().main(["--device", "cpu", "--rtols", "1e-6", "--ref-rtol", "1e-8"])


def test_the_reference_matches_jax(ladder):
    _, n_ref, _ = _jax("radau", 1e-8)
    assert ladder["case"]["reference"] == f"our radau @ rtol=1e-08 ({n_ref} steps)"
    assert ladder["ok"] and ladder["failed"] == [] and ladder["platform"] == "cpu"


@pytest.mark.parametrize("method", ["radau", "midpoint", "rk45"])
def test_steps_and_true_error_match_jax(ladder, method):
    m_ref, _, _ = _jax("radau", 1e-8)
    m, nacc, nrej = _jax(method, 1e-6)
    (row,) = [e for e in ladder["ladder"] if e["method"] == method]
    assert row["rtol"] == 1e-6 and row["success"]
    assert (row["accepted_steps"], row["rejected_steps"]) == (nacc, nrej)
    np.testing.assert_allclose(row["true_error"], np.linalg.norm(m - m_ref), rtol=1e-6)


def test_counts_match_the_recorded_jax_ladder(ladder):
    recorded = json.loads((ROOT / "docs" / "STIFF_SOLVER_STEPS.json").read_text())
    want = {(e["method"], e["rtol"]): (e["accepted_steps"], e["rejected_steps"])
            for e in recorded["ladder"]}
    for row in ladder["ladder"]:
        assert (row["accepted_steps"], row["rejected_steps"]) == want[(row["method"], row["rtol"])]
    (scipy_row,) = ladder["scipy_radau_baseline"]
    assert scipy_row["rtol"] == 1e-6 and scipy_row["accepted_steps"] > 0
    assert ladder["summary"]["radau_rtol1e6_steps"] == want[("radau", 1e-6)][0]
