"""Single-domain magnetic energy landscape analysis.

PyTorch counterpart of ``spintorque_tpu/physics/energy_landscape.py``.
Every analysis is one batched evaluation over a (theta, phi) grid, in
float64 on the device of the parameters: the effective field by autograd
(``jax.grad`` in the JAX package), the phase diagram by broadcasting over
(field, angle, theta) (its nested ``vmap``). The local-minimum search over
the energy surface runs on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..constants import KB, MU0
from .llgs import LLGSParams

Tensor = torch.Tensor


def _spherical_to_cart(theta, phi):
    st = torch.sin(theta)
    return st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)


class EnergyLandscape:
    """Energy landscape utilities for a uniaxial single-domain particle.

    E(m) = -mu0 Ms V (m . H) - K_u V (m . e)^2 + (1/2) mu0 Ms^2 V N m_z^2
    (thin-film demag factor N = 1 along z). The parameters are taken in
    float64 on their device, where every method computes.
    """

    def __init__(self, params: LLGSParams, include_demag: bool = True):
        self.params = params.to(dtype=torch.float64)
        self.device = self.params.volume.device
        self.include_demag = include_demag

    def _t(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def energy(self, m, applied_field=(0.0, 0.0, 0.0)) -> Tensor:
        """Total energy (J) for magnetization direction(s) m (..., 3)."""
        p = self.params
        m = self._t(m)
        mx, my, mz = m[..., 0], m[..., 1], m[..., 2]
        e = p.easy_axis
        e = e / torch.linalg.vector_norm(e)
        h = self._t(applied_field)
        vol = p.volume
        ms = p.saturation_magnetization
        zeeman = -MU0 * ms * vol * (mx * h[..., 0] + my * h[..., 1] + mz * h[..., 2])
        m_dot_e = mx * e[0] + my * e[1] + mz * e[2]
        anis = -p.uniaxial_anisotropy * vol * m_dot_e**2
        demag = 0.5 * MU0 * ms**2 * vol * mz**2 if self.include_demag else 0.0
        return zeeman + anis + demag

    def energy_surface(self, n_theta: int = 90, n_phi: int = 180,
                       applied_field=(0.0, 0.0, 0.0)) -> Dict[str, Tensor]:
        """The full (theta, phi) energy surface in one evaluation."""
        theta = torch.linspace(0.0, math.pi, n_theta, dtype=torch.float64, device=self.device)
        phi = torch.linspace(0.0, 2 * math.pi, n_phi, dtype=torch.float64, device=self.device)
        tt, pp = torch.meshgrid(theta, phi, indexing="ij")
        m = torch.stack(_spherical_to_cart(tt, pp), dim=-1)
        return {"theta": theta, "phi": phi, "energy": self.energy(m, applied_field)}

    def effective_field(self, m, applied_field=(0.0, 0.0, 0.0)) -> Tensor:
        """H_eff = -dE/dm / (mu0 Ms V), by autograd."""
        p = self.params
        m = self._t(m).detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(torch.sum(self.energy(m, applied_field)), m)
        return -grad / (MU0 * p.saturation_magnetization * p.volume)

    def find_stable_states(self, n_theta: int = 181, n_phi: int = 360,
                           applied_field=(0.0, 0.0, 0.0),
                           energy_tol: float = 1e-25) -> np.ndarray:
        """Grid-based local-minimum search: evaluate the full surface, keep
        the directions no higher than all 8 neighbours (and the poles),
        dedupe nearly-degenerate states, lowest energy first."""
        surf = self.energy_surface(n_theta, n_phi, applied_field)
        E = surf["energy"].cpu().numpy()
        theta, phi = surf["theta"].cpu().numpy(), surf["phi"].cpu().numpy()
        Ew = np.concatenate([E[:, -1:], E, E[:, :1]], axis=1)  # phi wraps
        mins = []
        for i in range(1, E.shape[0] - 1):
            for j in range(E.shape[1]):
                window = Ew[i - 1: i + 2, j: j + 3]
                if E[i, j] <= window.min() + 0.0:
                    mins.append((theta[i], phi[j], E[i, j]))
        if E[0].min() <= E[1].min():
            mins.append((0.0, 0.0, float(E[0].min())))
        if E[-1].min() <= E[-2].min():
            mins.append((np.pi, 0.0, float(E[-1].min())))
        states = []
        for t, p_, e in mins:
            m = np.array([np.sin(t) * np.cos(p_), np.sin(t) * np.sin(p_), np.cos(t)])
            if not any(np.dot(m, s) > 0.999 for s, _ in states):
                states.append((m, e))
        states.sort(key=lambda x: x[1])
        return np.array([s for s, _ in states])

    def energy_barrier(self, m_from, m_to, n_points: int = 100,
                       applied_field=(0.0, 0.0, 0.0)) -> float:
        """Barrier along the normalized linear interpolation path."""
        m_from, m_to = self._t(m_from), self._t(m_to)
        t = torch.linspace(0.0, 1.0, n_points, dtype=torch.float64, device=self.device)[:, None]
        path = (1 - t) * m_from[None, :] + t * m_to[None, :]
        path = path / torch.linalg.vector_norm(path, dim=-1, keepdim=True)
        E = self.energy(path, applied_field)
        return float(torch.max(E) - E[0])

    def thermal_stability_factor(self, temperature: float = 300.0) -> float:
        """Delta = K_u V / k_B T."""
        p = self.params
        return float(p.uniaxial_anisotropy * p.volume / (KB * temperature))

    def switching_phase_diagram(self, field_range: Tuple[float, float], n_fields: int = 50,
                                n_angles: int = 50) -> Dict[str, Tensor]:
        """Stoner-Wohlfarth-style astroid: for each (H, angle), does the
        in-plane energy over theta keep two minima? One broadcast
        evaluation over (field, angle, theta)."""
        p = self.params
        h_k = 2 * p.uniaxial_anisotropy / (MU0 * p.saturation_magnetization)
        fields = torch.linspace(field_range[0], field_range[1], n_fields, dtype=torch.float64,
                                device=self.device)
        angles = torch.linspace(0.0, math.pi / 2, n_angles, dtype=torch.float64,
                                device=self.device)
        theta = torch.linspace(0.0, math.pi, 181, dtype=torch.float64, device=self.device)
        hx = (fields[:, None] * torch.sin(angles)[None, :])[..., None]
        hz = (fields[:, None] * torch.cos(angles)[None, :])[..., None]
        mx, mz = torch.sin(theta), torch.cos(theta)
        # in-plane (x, z) energy per unit: -h.m - 0.5 h_k (m.e)^2
        e = -(hx * mx + hz * mz) - 0.5 * h_k * mz**2
        interior = (e[..., 1:-1] < e[..., :-2]) & (e[..., 1:-1] < e[..., 2:])
        n_minima = interior.sum(-1) + (e[..., 0] < e[..., 1]) + (e[..., -1] < e[..., -2])
        return {"fields": fields, "angles": angles, "bistable": n_minima >= 2,
                "anisotropy_field": h_k}
