"""The JAX package's order test of its Radau IIA (tests/unit/test_adaptive.py),
ported to spintorque_tpu_torch: on the stiff high-damping transient, at
the same rtol (comparable step counts), Radau's global error is >= 1000x
below the implicit midpoint's, and the midpoint does not reach it with 10x
the steps. The reference solution is Radau at rtol 1e-10, where the JAX
test takes 1e-12: on this input the two references agree to 1.6e-16,
against a Radau error at rtol 1e-6 of 1.7e-11, at a third of the cost.
"""

import numpy as np
import torch

from spintorque_tpu_torch.physics import LLGSParams, integrate_adaptive

torch.set_num_threads(1)


def test_radau_order5_beats_midpoint_steps_to_accuracy():
    stiff = LLGSParams(
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in dict(
            saturation_magnetization=800e3, damping=0.5, uniaxial_anisotropy=1.2e6,
            volume=1e-23, polarization=0.7).items()},
        easy_axis=torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))
    m0 = (torch.tensor([0.6], dtype=torch.float64), torch.tensor([0.0], dtype=torch.float64),
          torch.tensor([0.8], dtype=torch.float64))
    spans = torch.tensor([5e-11], dtype=torch.float64)
    cur = torch.zeros(1, dtype=torch.float64)

    def run(meth, rtol):
        r = integrate_adaptive(m0, spans, cur, stiff, rtol=rtol, atol=rtol * 1e-3, dt_max=5e-10,
                               max_steps=500_000, method=meth)
        assert bool(r.success.all())
        return torch.stack(r.m, dim=-1).numpy()[0], int(r.n_steps[0])

    m_ref, _ = run("radau", 1e-10)
    m_rad, n_rad = run("radau", 1e-6)
    m_mid, n_mid = run("midpoint", 1e-6)
    m_mid10, n_mid10 = run("midpoint", 1e-10)
    err_rad = np.linalg.norm(m_rad - m_ref)
    err_mid = np.linalg.norm(m_mid - m_ref)
    err_mid10 = np.linalg.norm(m_mid10 - m_ref)
    assert n_rad < 2 * n_mid, (n_rad, n_mid)
    assert err_rad < 1e-3 * err_mid, (err_rad, err_mid)
    assert n_mid10 > 10 * n_rad, (n_mid10, n_rad)
    assert err_mid10 > err_rad, (err_mid10, err_rad)


