"""Device parameter structs and canonical defaults.

PyTorch counterpart of ``spintorque_tpu/devices/params.py``. A device is a
dataclass of tensors: every field is 0-dim (shared by the env batch) or (B,)
(per-env heterogeneous devices), except the axis vectors, (3,) or (B, 3).
The default parameter sets are the JAX package's, which reproduce the
reference factory's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..constants import EPSILON0
from ..physics.llgs import LLGSParams

Tensor = torch.Tensor

DEVICE_TYPES = ("stt_mram", "sot_mram", "vcma_mram", "skyrmion", "skyrmion_track")


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    """Unified spintronic device parameters (a superset of every device
    type's; fields irrelevant to a type hold that type's defaults)."""

    # Geometry
    volume: Tensor
    area: Tensor
    thickness: Tensor
    aspect_ratio: Tensor
    # Magnetics
    saturation_magnetization: Tensor
    damping: Tensor
    uniaxial_anisotropy: Tensor
    exchange_constant: Tensor
    polarization: Tensor
    easy_axis: Tensor  # (3,) or (B, 3)
    reference_magnetization: Tensor  # (3,) or (B, 3)
    # Electrical
    resistance_parallel: Tensor
    resistance_antiparallel: Tensor
    # SOT
    spin_hall_angle: Tensor
    heavy_metal_thickness: Tensor
    heavy_metal_resistivity: Tensor
    interface_transparency: Tensor
    field_like_efficiency: Tensor
    damping_like_efficiency: Tensor
    # VCMA
    vcma_coefficient: Tensor
    dielectric_thickness: Tensor
    dielectric_constant: Tensor
    breakdown_voltage: Tensor
    leakage_resistance: Tensor
    # Skyrmion
    dmi_constant: Tensor
    skyrmion_radius: Tensor
    track_width: Tensor
    pinning_strength: Tensor

    def llgs(self) -> LLGSParams:
        """The parameter subset read by the LLGS hot loop."""
        return LLGSParams(
            saturation_magnetization=self.saturation_magnetization,
            damping=self.damping,
            uniaxial_anisotropy=self.uniaxial_anisotropy,
            volume=self.volume,
            polarization=self.polarization,
            easy_axis=self.easy_axis,
        )

    # --- derived SOT quantities ---
    def sot_js_efficiency(self):
        return (
            self.spin_hall_angle
            * self.interface_transparency
            * (self.heavy_metal_thickness / (self.heavy_metal_thickness + self.thickness))
        )

    def sot_tau_dl_factor(self):
        return self.damping_like_efficiency * self.sot_js_efficiency()

    def sot_tau_fl_factor(self):
        return self.field_like_efficiency * self.sot_js_efficiency()

    def sot_sheet_resistance(self):
        return self.heavy_metal_resistivity / self.heavy_metal_thickness

    # --- derived VCMA quantity ---
    def vcma_capacitance(self):
        return EPSILON0 * self.dielectric_constant * self.area / self.dielectric_thickness


# Canonical defaults (plain dicts, merged with user overrides before the
# conversion to tensors).
_STT_DEFAULTS: Dict[str, Any] = dict(
    volume=50e-9 * 100e-9 * 2e-9,
    area=50e-9 * 100e-9,
    thickness=2e-9,
    aspect_ratio=2.0,
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1.2e6,
    exchange_constant=20e-12,
    polarization=0.7,
    resistance_parallel=1e3,
    resistance_antiparallel=2e3,
    easy_axis=np.array([0.0, 0.0, 1.0]),
    reference_magnetization=np.array([0.0, 0.0, 1.0]),
)

_SOT_DEFAULTS: Dict[str, Any] = dict(
    volume=100e-9 * 100e-9 * 1e-9,
    area=100e-9 * 100e-9,
    thickness=1e-9,
    aspect_ratio=1.0,
    saturation_magnetization=800e3,
    damping=0.015,
    uniaxial_anisotropy=0.8e6,
    exchange_constant=20e-12,
    spin_hall_angle=0.2,
    resistance_parallel=500.0,
    resistance_antiparallel=1000.0,
    easy_axis=np.array([0.0, 0.0, 1.0]),
)

_VCMA_DEFAULTS: Dict[str, Any] = dict(
    volume=80e-9 * 80e-9 * 1.5e-9,
    area=80e-9 * 80e-9,
    thickness=1.5e-9,
    aspect_ratio=1.0,
    saturation_magnetization=800e3,
    damping=0.008,
    uniaxial_anisotropy=1.5e6,
    exchange_constant=20e-12,
    vcma_coefficient=100e-6,
    resistance_parallel=2e3,
    resistance_antiparallel=4e3,
    easy_axis=np.array([0.0, 0.0, 1.0]),
)

_SKYRMION_DEFAULTS: Dict[str, Any] = dict(
    volume=200e-9 * 50e-9 * 0.5e-9,
    area=200e-9 * 50e-9,
    thickness=0.5e-9,
    aspect_ratio=1.0,
    saturation_magnetization=600e3,
    damping=0.02,
    dmi_constant=3e-3,
    exchange_constant=15e-12,
    skyrmion_radius=10e-9,
    easy_axis=np.array([0.0, 0.0, 1.0]),
)

# Fields every DeviceParams carries, with the cross-type fallbacks.
_GLOBAL_FALLBACKS: Dict[str, Any] = dict(
    volume=1e-24,
    area=1e-14,
    thickness=1e-9,
    aspect_ratio=1.0,
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1e6,
    exchange_constant=20e-12,
    polarization=0.7,
    easy_axis=np.array([0.0, 0.0, 1.0]),
    reference_magnetization=np.array([0.0, 0.0, 1.0]),
    resistance_parallel=1e3,
    resistance_antiparallel=2e3,
    spin_hall_angle=0.1,
    heavy_metal_thickness=5e-9,
    heavy_metal_resistivity=2e-7,
    interface_transparency=0.5,
    field_like_efficiency=0.1,
    damping_like_efficiency=0.2,
    vcma_coefficient=100e-6,
    dielectric_thickness=1e-9,
    dielectric_constant=25.0,
    breakdown_voltage=2.0,
    leakage_resistance=1e12,
    dmi_constant=3e-3,
    skyrmion_radius=20e-9,
    track_width=200e-9,
    pinning_strength=0.1,
)

_TYPE_DEFAULTS = {
    "stt_mram": _STT_DEFAULTS,
    "sot_mram": _SOT_DEFAULTS,
    "vcma_mram": _VCMA_DEFAULTS,
    "skyrmion": _SKYRMION_DEFAULTS,
    "skyrmion_track": _SKYRMION_DEFAULTS,
}

# Informational keys an override may carry without being a field.
_ALLOWED_EXTRA = {
    "temperature", "length", "width", "resistivity", "anisotropy_constant",
    "base_resistance", "skyrmion_resistance_factor", "capacitance_per_area",
    "perpendicular_anisotropy", "heavy_metal_layer", "ferromagnet_layer",
}


def default_device_dict(device_type: str) -> Dict[str, Any]:
    """Full parameter dict for a device type (type defaults merged over the
    global fallbacks)."""
    device_type = device_type.lower()
    if device_type not in _TYPE_DEFAULTS:
        raise ValueError(
            f"Unknown device type '{device_type}'. Available: {list(_TYPE_DEFAULTS)}"
        )
    merged = dict(_GLOBAL_FALLBACKS)
    merged.update(_TYPE_DEFAULTS[device_type])
    return merged


def validate_device_dict(device_type: str, params: Dict[str, Any]) -> None:
    """Range validation of the shared parameters."""
    if params["volume"] <= 0:
        raise ValueError("Volume must be positive")
    if params["saturation_magnetization"] <= 0:
        raise ValueError("Saturation magnetization must be positive")
    if not 0 <= params["damping"] <= 1:
        raise ValueError("Damping must be between 0 and 1")
    if device_type == "stt_mram" and not 0 <= params["polarization"] <= 1:
        raise ValueError("Polarization must be between 0 and 1")


def make_device_params(
    device_type: str,
    overrides: Dict[str, Any] | None = None,
    dtype=torch.float32,
    validate: bool = True,
    *,
    device,
) -> DeviceParams:
    """DeviceParams for ``device_type`` with optional overrides, as tensors
    of ``dtype`` on ``device``."""
    merged = default_device_dict(device_type)
    if overrides:
        unknown = set(overrides) - set(merged)
        merged.update({k: v for k, v in overrides.items() if k in merged})
        if unknown and validate:
            bad = unknown - _ALLOWED_EXTRA
            if bad:
                raise ValueError(f"Unknown device parameters: {sorted(bad)}")
    if validate:
        validate_device_dict(device_type, merged)

    def conv(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    return DeviceParams(**{k: conv(v) for k, v in merged.items()})
