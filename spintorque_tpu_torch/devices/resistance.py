"""Per-device-type resistance and pulse energy.

PyTorch counterpart of the part of ``spintorque_tpu/devices/resistance.py``
that the env step reads. Both functions broadcast over (B,) magnetization
components and 0-dim or (B,) parameters; ``device_type`` is a plain string.
"""

from __future__ import annotations

import torch

from .params import DeviceParams


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
