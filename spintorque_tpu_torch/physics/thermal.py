"""Thermal fluctuation models and stability analytics.

PyTorch counterpart of ``spintorque_tpu/physics/thermal.py``. The in-loop
thermal field lives in the pulse integrator (the Philox stream of
``ops/philox.py``); this module holds the analytic and stochastic
utilities around it: Brown's noise strength, Neel-Brown switching
statistics, retention, stability factors and temperature sweeps, each a
batched tensor expression that broadcasts over devices and temperatures.

Arguments may be Python numbers, arrays or tensors. Numbers and numpy
arrays become float64 tensors (the JAX package computes them in float64
under 64-bit types), tensors keep their dtype; all live on the instance's
device. The JAX package splits a PRNG key for each draw; here the draws
come from a torch.Generator on that device, seeded from ``seed``, so the
two packages agree in distribution, not in bits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..constants import GAMMA, KB, MU0
from .llgs import _rdiv

Tensor = torch.Tensor

SECONDS_PER_YEAR = 365.25 * 24 * 3600


class ThermalFluctuations:
    """Thermal fluctuation model.

    ``device`` is "cuda" unless the caller asks for "cpu"; the noise draws
    come from a torch.Generator there, seeded with ``seed`` (0 when None).
    """

    def __init__(
        self,
        temperature: float = 300.0,
        correlation_time: float = 1e-12,
        seed: Optional[int] = None,
        *,
        device=None,
    ):
        from ..parallel.mesh import resolve_device

        self.temperature = temperature
        self.correlation_time = correlation_time
        self.device = resolve_device(device, None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0 if seed is None else seed)
        self._previous_noise = torch.zeros(3, dtype=torch.float64, device=self.device)

    def set_temperature(self, temperature: float) -> None:
        self.temperature = temperature

    def _t(self, x) -> Tensor:
        """``x`` as a tensor on the device: numbers and numpy arrays as
        float64, tensors in their floating dtype."""
        if isinstance(x, Tensor):
            t = x.to(self.device)
            return t if t.is_floating_point() else t.to(torch.float64)
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device)

    def compute_noise_strength(self, damping, saturation_magnetization, volume,
                               gamma: float = GAMMA) -> Tensor:
        """Brown's RMS thermal field. Broadcasts."""
        variance = (
            2.0 * self._t(damping) * KB * self.temperature
            / (gamma * MU0 * self._t(saturation_magnetization) * self._t(volume))
        )
        return torch.sqrt(variance) if self.temperature > 0 else torch.zeros_like(variance)

    def generate_thermal_field(
        self,
        damping,
        saturation_magnetization,
        volume,
        dt: float,
        gamma: float = GAMMA,
        correlated: bool = True,
        shape: Tuple[int, ...] = (),
    ) -> Tensor:
        """White or Ornstein-Uhlenbeck-correlated field draw. ``shape``
        prefixes batch dims."""
        strength = self.compute_noise_strength(damping, saturation_magnetization, volume, gamma)
        white = torch.randn(tuple(shape) + (3,), generator=self.generator,
                            dtype=strength.dtype, device=self.device)
        if correlated and self.correlation_time > 0:
            decay = math.exp(-dt / self.correlation_time)
            prev = torch.broadcast_to(self._previous_noise.to(strength.dtype), white.shape)
            corr = decay * prev + math.sqrt(1.0 - decay**2) * white
            self._previous_noise = corr if tuple(shape) == () else corr.reshape(-1, 3)[0]
            white = corr
        return strength[..., None] * white if strength.ndim else strength * white

    def compute_thermal_barrier(self, anisotropy_constant, volume) -> Tensor:
        """Thermal stability factor Delta = K_u V / k_B T."""
        if self.temperature > 0:
            return self._t(anisotropy_constant) * self._t(volume) / (KB * self.temperature)
        return torch.full_like(self._t(anisotropy_constant) * self._t(volume), math.inf)

    def compute_switching_probability(self, energy_barrier, attempt_frequency: float = 1e9,
                                      measurement_time: float = 1e-9) -> Tensor:
        """Neel-Brown switching probability."""
        barrier = self._t(energy_barrier)
        if not self.temperature > 0:
            return torch.zeros_like(barrier)
        rate = attempt_frequency * torch.exp(-barrier / (KB * self.temperature))
        prob = 1.0 - torch.exp(-rate * measurement_time)
        return torch.clamp_max(prob, 1.0)

    def sample_switching_time(self, energy_barrier, attempt_frequency: float = 1e9,
                              shape: Tuple[int, ...] = ()) -> Tensor:
        """Exponentially distributed switching time samples."""
        rate = attempt_frequency * torch.exp(-self._t(energy_barrier) / (KB * self.temperature))
        u = torch.rand(tuple(shape), generator=self.generator, dtype=rate.dtype,
                       device=self.device)
        u = 1e-12 + (1.0 - 1e-12) * u
        t = -torch.log(u) / rate
        return torch.where(rate > 0, t, math.inf)

    def compute_retention_time(self, energy_barrier, failure_rate: float = 1e-9,
                               attempt_frequency: float = 1e9) -> Tensor:
        """Retention time at a given failure rate."""
        barrier = self._t(energy_barrier)
        if not self.temperature > 0:
            return torch.full_like(barrier, math.inf)
        thermal_factor = barrier / (KB * self.temperature)
        return _rdiv(-math.log(failure_rate), attempt_frequency * torch.exp(-thermal_factor))

    def analyze_thermal_stability(self, device_params: dict, time_scale: float = 10.0) -> Dict:
        """Stability report. ``time_scale`` in years."""
        volume = device_params.get("volume", 1e-24)
        k_u = device_params.get("uniaxial_anisotropy", 1e6)
        energy_barrier = k_u * volume
        delta = self.compute_thermal_barrier(k_u, volume)
        switch_prob = self.compute_switching_probability(
            energy_barrier, measurement_time=time_scale * SECONDS_PER_YEAR
        )
        retention_years = self.compute_retention_time(energy_barrier) / SECONDS_PER_YEAR
        return {
            "thermal_stability_factor": float(delta),
            "energy_barrier_J": float(energy_barrier),
            "energy_barrier_kT": float(energy_barrier / (KB * self.temperature)),
            "switching_probability": float(switch_prob),
            "retention_time_years": float(retention_years),
            "is_thermally_stable": bool(delta > 40),
            "temperature_K": self.temperature,
        }

    def generate_temperature_sweep(self, temp_range: Tuple[float, float], device_params: dict,
                                   n_points: int = 100) -> Dict[str, Tensor]:
        """Temperature sweep in one broadcast evaluation."""
        temps = torch.linspace(temp_range[0], temp_range[1], n_points, dtype=torch.float64,
                               device=self.device)
        volume = device_params.get("volume", 1e-24)
        k_u = device_params.get("uniaxial_anisotropy", 1e6)
        damping = device_params.get("damping", 0.01)
        ms = device_params.get("saturation_magnetization", 800e3)
        barrier = k_u * volume

        delta = _rdiv(barrier, KB * temps)
        rate = 1e9 * torch.exp(-delta)
        switch_prob = torch.clamp_max(1.0 - torch.exp(-rate * SECONDS_PER_YEAR), 1.0)
        retention_years = _rdiv(-math.log(1e-9), rate) / SECONDS_PER_YEAR
        noise = torch.sqrt(2.0 * damping * KB * temps / (GAMMA * MU0 * ms * volume))
        return {
            "temperature": temps,
            "thermal_stability_factor": delta,
            "switching_probability": switch_prob,
            "retention_time": retention_years,
            "noise_strength": noise,
        }
