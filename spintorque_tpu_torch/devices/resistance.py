"""Per-device-type resistance, pulse energy and switching analytics.

PyTorch counterpart of ``spintorque_tpu/devices/resistance.py``: STT / SOT /
VCMA resistance, pulse energy, the VCMA and SOT switching estimates and the
uniaxial barrier. Every function broadcasts over (B,) magnetization
components and 0-dim or (B,) parameters; ``device_type`` is a plain string.
Numbers given for a voltage, current or temperature become tensors in the
dtype and on the device of the parameters.
"""

from __future__ import annotations

import math

import torch

from ..constants import GAMMA, KB_SOLVER, MU0
from .params import DeviceParams

Tensor = torch.Tensor


def _cos_theta_with_reference(mx, my, mz, params: DeviceParams):
    ref = params.reference_magnetization
    rx, ry, rz = ref[..., 0], ref[..., 1], ref[..., 2]
    norm = torch.sqrt(rx * rx + ry * ry + rz * rz)
    rx, ry, rz = rx / norm, ry / norm, rz / norm
    return mx * rx + my * ry + mz * rz


def resistance(device_type: str, mx, my, mz, params: DeviceParams):
    """Device resistance (Ohm) from the magnetization state."""
    cos_theta = _cos_theta_with_reference(mx, my, mz, params)
    r_p = params.resistance_parallel
    r_ap = params.resistance_antiparallel
    if device_type == "stt_mram":
        # R = R_p (1 + TMR (1 - cos) / 2), floored at 0.5 R_p.
        tmr = (r_ap - r_p) / r_p
        r = r_p * (1.0 + tmr * (1.0 - cos_theta) / 2.0)
        return torch.maximum(r, r_p * 0.5)
    if device_type == "sot_mram":
        # MTJ TMR + a small series term from the heavy-metal sheet resistance.
        r_mtj = r_p + (r_ap - r_p) * (1.0 - cos_theta) / 2.0
        r_hm = params.sot_sheet_resistance() / (params.area * 1e-12)
        return torch.clamp_min(r_mtj + 0.1 * r_hm, 1.0)
    if device_type in ("vcma_mram", "skyrmion", "skyrmion_track"):
        # Skyrmion resistance vs count belongs to the skyrmion env; for a
        # magnetization query it is the TMR form, as for VCMA.
        r = r_p + (r_ap - r_p) * (1.0 - cos_theta) / 2.0
        return torch.clamp_min(r, 1.0)
    raise ValueError(f"Unknown device type: {device_type}")


def pulse_energy(current_density, duration, r, area):
    """Joule energy of a square pulse at pre-step resistance r:
    E = V^2 / R * dt with V = J R A, gated on |J| > 1e-12."""
    voltage = current_density * r * area
    e = voltage * voltage / r * duration
    return torch.where(current_density.abs() > 1e-12, e, 0.0)


def params_tensor(x, params: DeviceParams) -> Tensor:
    """``x`` as a tensor in the dtype and on the device of ``params``."""
    ref = params.volume
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def vcma_effective_anisotropy(voltage, params: DeviceParams):
    """K_eff(V) = K0 - xi |V| / t^2, clamped at -0.5 K0."""
    v_bd = params.breakdown_voltage
    v = torch.clamp(params_tensor(voltage, params), -v_bd, v_bd)
    delta_k = -params.vcma_coefficient * v.abs() / (params.dielectric_thickness**2)
    k_eff = params.uniaxial_anisotropy + delta_k
    return torch.maximum(k_eff, -0.5 * params.uniaxial_anisotropy)


def vcma_pulse_energy(voltage, duration, params: DeviceParams):
    """0.5 C V^2 capacitive + leakage energy, gated on |V| > 1e-12."""
    voltage = params_tensor(voltage, params)
    cap = params.vcma_capacitance()
    e = 0.5 * cap * voltage**2 + voltage**2 * duration / params.leakage_resistance
    return torch.where(voltage.abs() > 1e-12, e, 0.0)


def vcma_leakage_current(voltage, params: DeviceParams):
    """Dielectric leakage current: ohmic plus simplified Fowler-Nordheim
    tunneling above 1e8 V/m,

    I = V / R_leak + [E > 1e8] * 1e-6 * E * exp(-3.5e9 / E) * A

    with E = |V| / t_dielectric. The tunneling term is masked and its
    exponent's field floored at 1, so the unused branch stays finite."""
    voltage = params_tensor(voltage, params)
    ohmic = voltage / params.leakage_resistance
    field = voltage.abs() / params.dielectric_thickness
    safe_field = torch.clamp_min(field, 1.0)
    tunneling = 1e-6 * field * torch.exp(-3.5e9 / safe_field) * params.area
    current = ohmic + torch.where(field > 1e8, tunneling, 0.0)
    return torch.where(voltage.abs() > 1e-12, current, 0.0)


def vcma_switching_time(voltage, params: DeviceParams, temperature=300.0):
    """Arrhenius switching-time estimate at the voltage-modified barrier:
    t = (1/f0) exp(E_b / kT) with f0 = 1 GHz; 1 ps when the barrier is
    gone, inf below 1 uV of drive."""
    voltage = params_tensor(voltage, params)
    k_eff = vcma_effective_anisotropy(voltage, params)
    barrier = k_eff * params.volume
    t = (1.0 / 1e9) * torch.exp(barrier / (KB_SOLVER * temperature))
    t = torch.where(barrier <= 0.0, 1e-12, t)
    return torch.where(voltage.abs() < 1e-6, math.inf, t)


def vcma_switching_probability(voltage, duration, params: DeviceParams, temperature=300.0):
    """Arrhenius switching with the voltage-lowered barrier."""
    k_eff = vcma_effective_anisotropy(voltage, params)
    barrier = k_eff * params.volume
    thermal = KB_SOLVER * temperature
    rate = 1e9 * torch.exp(-barrier / thermal)
    prob = 1.0 - torch.exp(-rate * duration)
    prob = torch.where(barrier <= 0, 1.0, torch.clamp_max(prob, 1.0))
    cold = torch.as_tensor(thermal <= 0, device=barrier.device)
    return torch.where(cold, torch.where(barrier <= 0, 1.0, 0.0).to(prob.dtype), prob)


def sot_torque_factors(params: DeviceParams):
    """(tau_DL, tau_FL) efficiency factors."""
    return params.sot_tau_dl_factor(), params.sot_tau_fl_factor()


def sot_spin_torques(current_density, mx, my, mz, params: DeviceParams,
                     current_direction=(1.0, 0.0, 0.0)):
    """SOT damping-like and field-like torques with sigma = z x j.
    Returns ((dlx, dly, dlz), (flx, fly, flz))."""
    jx, jy, jz = (params_tensor(c, params) for c in current_direction)
    mx, my, mz = (params_tensor(c, params) for c in (mx, my, mz))
    norm = torch.sqrt(jx * jx + jy * jy + jz * jz)
    jx, jy, jz = jx / norm, jy / norm, jz / norm
    # sigma = z_hat x j_hat
    sx, sy, sz = -jy, jx, torch.zeros_like(jx + mx * 0.0)
    current_density = params_tensor(current_density, params)
    tau_dl = params.sot_tau_dl_factor() * current_density
    tau_fl = params.sot_tau_fl_factor() * current_density
    # DL: tau_dl * (sigma x m)
    dlx = tau_dl * (sy * mz - sz * my)
    dly = tau_dl * (sz * mx - sx * mz)
    dlz = tau_dl * (sx * my - sy * mx)
    return (dlx, dly, dlz), (tau_fl * sx, tau_fl * sy, tau_fl * sz)


def sot_switching_threshold(params: DeviceParams):
    """Critical current density j_c for SOT switching."""
    h_k = 2.0 * params.uniaxial_anisotropy / (MU0 * params.saturation_magnetization)
    return (
        5e6
        * (1.0 + params.damping)
        * (1.0 + h_k / 1e6)
        / (1.0 + params.sot_tau_dl_factor())
    )


def sot_switching_time(current_density, params: DeviceParams, temperature=300.0):
    """Thermally activated (below j_c) or deterministic (above) switching
    time; inf below 1 uA/m^2."""
    j_c = sot_switching_threshold(params)
    j = params_tensor(current_density, params).abs()
    barrier = params.uniaxial_anisotropy * params.volume
    assist = j / j_c
    thermal_time = (1.0 / 1e9) * torch.exp(
        barrier / (KB_SOLVER * temperature) * (1.0 - assist)
    )
    det_time = (math.pi * params.damping) / (
        GAMMA * params.sot_tau_dl_factor() * torch.clamp_min(j, 1e-30)
    )
    t = torch.where(j < j_c, thermal_time, det_time)
    return torch.where(j < 1e-6, math.inf, t)


def energy_barrier(device_type: str, mx, my, mz, params: DeviceParams, voltage=0.0):
    """Uniaxial switching barrier; for VCMA the voltage-lowered one."""
    if device_type == "vcma_mram":
        k_eff = vcma_effective_anisotropy(voltage, params)
        return torch.clamp_min(k_eff.abs() * params.volume, 0.0)
    e = params.easy_axis
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    mx, my, mz = (params_tensor(c, params) for c in (mx, my, mz))
    cos_theta = (mx * ex + my * ey + mz * ez).abs()
    return params.uniaxial_anisotropy * params.volume * (1.0 - cos_theta**2)
