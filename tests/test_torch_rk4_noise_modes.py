"""The RK4 thermal sampling modes of the JAX package
(``tests/unit/test_rk4_noise_modes.py``) on the port's pulse, on the CPU:
'per_stage' draws an independent field for each of the four RK4 stages,
'per_substep' one field for all four.

* The sampling contract (the JAX file's ``:34``): through
  ``physics.integrator.noise_draws``, the Philox calls a substep asks of
  ``ops.philox.substep_normals`` (3 per-stage: 12 normals, 3 a stage; 1
  per-substep: 3 of its 4 normals), and the fields the four stages receive
  (four distinct per-stage, one shared per-substep).
* The variance gate (``:83``): on a nearly free layer (K_u = 1 J/m^3, zero
  current, B=2048 from +z, a 50 ps pulse, max_substeps 128, ``noise_mode=
  "physical"``, 300 K) the per-substep trajectories spread ~36/10 times
  wider in polar variance than the per-stage ones, whose iid stage draws
  average through the RK4 weights to sum(w^2) = 10/36. The ratio must lie
  in 2.4-5.4, the JAX test's bounds. The port draws from its Philox stream
  (seed 9 for JAX's PRNGKey(9)), so the gate holds in distribution.
"""

import numpy as np
import pytest
import torch

import spintorque_tpu_torch.physics.integrator as integ
from spintorque_tpu_torch.physics import IntegratorConfig, LLGSParams, integrate_pulse

torch.set_num_threads(1)


def _params(**over):
    vals = dict(saturation_magnetization=800e3, damping=0.01, uniaxial_anisotropy=1.2e6,
                volume=1e-23, polarization=0.7)
    vals.update(over)
    return LLGSParams(**{k: torch.tensor(v, dtype=torch.float32) for k, v in vals.items()},
                      easy_axis=torch.tensor([0.0, 0.0, 1.0]))


def _setup(B=64, seed=2):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(B, 3, generator=g)
    m = m / m.norm(dim=-1, keepdim=True)
    return ((m[:, 0], m[:, 1], m[:, 2]), torch.full((B,), 2e-10), torch.full((B,), 100.0))


@pytest.mark.parametrize("mode,draws,fields", [("per_substep", 1, 1), ("per_stage", 3, 4)])
def test_per_substep_draws_one_field_per_substep(monkeypatch, mode, draws, fields):
    """per_substep asks one Philox call a substep and hands its field to all
    four stages; per_stage asks three and hands each stage its own."""
    calls, distinct = [], []
    orig_normals, orig_fields = integ.philox.substep_normals, integ._stage_fields

    def normals_spy(seed, env_index, steps, n, dtype):
        calls.append(n)
        return orig_normals(seed, env_index, steps, n, dtype)

    def fields_spy(normals, sigma, config, stage_dtype):
        out = orig_fields(normals, sigma, config, stage_dtype)
        distinct.append(len({tuple(torch.cat(f).tolist()) for f in out}))
        assert len(out) == 4
        return out

    monkeypatch.setattr(integ.philox, "substep_normals", normals_spy)
    monkeypatch.setattr(integ, "_stage_fields", fields_spy)
    cfg = IntegratorConfig(method="rk4", max_substeps=256, thermal=True, rk4_noise=mode)
    assert integ.noise_draws(cfg) == draws
    m0, spans, cur = _setup()
    integrate_pulse(m0, spans, cur, _params(), cfg, seed=0)
    assert set(calls) == {draws}
    assert set(distinct) == {fields} and len(distinct) == 200  # one per substep


def test_per_substep_restores_full_noise_variance():
    """Per-stage iid draws average through the RK4 weights: the effective
    per-substep field variance deflates to sum(w^2) = (1+4+4+1)/36 = 10/36.
    per_substep keeps variance 1. Measured through the integrator on a
    nearly-free layer (tiny anisotropy, zero current), the per-substep
    trajectories must spread ~sqrt(36/10) ~ 1.9x wider."""
    B = 2048
    m0 = (torch.zeros(B), torch.zeros(B), torch.ones(B))
    spans = torch.full((B,), 5e-11)
    cur = torch.zeros(B)
    soft = _params(uniaxial_anisotropy=1.0)
    spread = {}
    for mode in ("per_stage", "per_substep"):
        cfg = IntegratorConfig(method="rk4", max_substeps=128, thermal=True,
                               noise_mode="physical", rk4_noise=mode)
        out = integrate_pulse(m0, spans, cur, soft, cfg, seed=9, temperature=300.0)
        # polar deviation from +z accumulates the thermal kicks
        spread[mode] = float(np.var(np.arccos(np.clip(out.m[2].numpy(), -1.0, 1.0))))
    ratio = spread["per_substep"] / spread["per_stage"]
    assert 2.4 < ratio < 5.4, f"variance ratio {ratio} (expect ~3.6)"
