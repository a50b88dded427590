"""Skyrmion device-level physics functions.

PyTorch counterpart of ``spintorque_tpu/devices/skyrmion_ops.py``:
Thiele-equation velocity, Hall angle, exchange length, skyrmion energy,
stability factor and count-dependent resistance, as batched functions of a
``DeviceParams``. The racetrack environment's own dynamics live in
``envs/skyrmion.py``; these are the standalone device-physics queries.
"""

from __future__ import annotations

import math

import torch

from ..constants import KB_SOLVER, MU0
from .params import DeviceParams
from .resistance import params_tensor

Tensor = torch.Tensor


def exchange_length(params: DeviceParams):
    """l_ex = sqrt(2A/K) with anisotropy, else sqrt(2A/(mu0 Ms^2)). Both
    branches are evaluated; K is floored at 1e-30 so that the unused one
    stays finite."""
    a = params.exchange_constant
    k = params.uniaxial_anisotropy
    ms = params.saturation_magnetization
    with_k = torch.sqrt(2.0 * a / torch.clamp_min(k, 1e-30))
    without_k = torch.sqrt(2.0 * a / (MU0 * ms**2))
    return torch.where(k > 0, with_k, without_k)


def magnus_coefficient(params: DeviceParams):
    """G = 4 pi Ms t."""
    return 4.0 * math.pi * params.saturation_magnetization * params.thickness


def skyrmion_hall_angle(params: DeviceParams):
    """Empirical arctan(alpha/0.1), clipped to 5-45 degrees."""
    angle = torch.arctan(params.damping / 0.1)
    return torch.clamp(angle, math.radians(5.0), math.radians(45.0))


def skyrmion_velocity(params: DeviceParams, current_density, external_force=(0.0, 0.0)) -> Tensor:
    """Thiele-like velocity v = F_total / (alpha G) for a current density of
    shape (..., 2), [Jx, Jy]; batched over the leading dimensions."""
    j = params_tensor(current_density, params)
    j_mag = torch.sqrt((j * j).sum(-1, keepdim=True))
    safe = torch.clamp_min(j_mag, 1e-30)
    j_dir = j / safe
    mobility = params.spin_hall_angle * params.interface_transparency
    g = magnus_coefficient(params)
    mass_eff = g * params.skyrmion_radius**2
    force_mag = mobility * j_mag * mass_eff
    f_drive = force_mag * j_dir
    perp = torch.stack([-j_dir[..., 1], j_dir[..., 0]], dim=-1)
    f_magnus = force_mag * torch.tan(skyrmion_hall_angle(params)) * perp
    f = torch.where(j_mag > 1e-12, f_drive + f_magnus, 0.0)
    f = f + params_tensor(external_force, params)
    damping_coeff = params.damping * g
    return f / damping_coeff


def skyrmion_energy(params: DeviceParams):
    """E = 8 pi A - 4 pi D r + pi K r^2 t + demag."""
    a = params.exchange_constant
    d = params.dmi_constant
    r = params.skyrmion_radius
    k = params.uniaxial_anisotropy
    t = params.thickness
    ms = params.saturation_magnetization
    e_ex = 8.0 * math.pi * a
    e_dmi = -4.0 * math.pi * d * r
    e_anis = math.pi * k * r**2 * t
    e_demag = MU0 * ms**2 * r**2 * t / 2.0
    return e_ex + e_dmi + e_anis + e_demag


def skyrmion_stability(params: DeviceParams, position_y, temperature=300.0):
    """Stability factor in [0, 1] against 40 kT, halved near the track's
    edges."""
    e = skyrmion_energy(params).abs()
    thermal = KB_SOLVER * temperature
    stability = torch.clamp_max(e / (40.0 * thermal), 1.0)
    y = params_tensor(position_y, params)
    near_edge = (y < params.skyrmion_radius) | (y > params.track_width - params.skyrmion_radius)
    return torch.where(near_edge, stability * 0.5, stability)


def skyrmion_resistance(params: DeviceParams, n_skyrmions, base_resistance: float = 1e3,
                        resistance_factor: float = 0.1):
    """R = R0 (1 + f * n) from the skyrmions' topological contribution."""
    n = params_tensor(n_skyrmions, params)
    return torch.clamp_min(base_resistance * (1.0 + resistance_factor * n), 1.0)
