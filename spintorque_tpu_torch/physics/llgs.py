"""Batched Landau-Lifshitz-Gilbert-Slonczewski (LLGS) right-hand side.

PyTorch counterpart of ``spintorque_tpu/physics/llgs.py``. The state of a
batch of B independent devices is kept as three (B,)-shaped component
tensors (structure of arrays), as in the JAX package, so that the functions
here, the plain integrator and the CUDA pulse kernel all apply the same
operations in the same order:

    H_eff = H_applied + H_anis + H_demag + H_thermal
    H_anis = (2 K_u / (mu0 Ms)) (m . e) e
    H_demag = -Ms m_z z_hat
    tau_STT = (P J / (Ms V)) m x (m x e)
    dm/dt = -gamma/(1+alpha^2) [m x H + alpha m x (m x H)] + tau_STT

Every function is dtype-polymorphic (float32 and float64) and broadcasts
device parameters: each may be a 0-dim tensor (shared by the batch) or a (B,)
tensor. Divisions whose numerator is a constant are written as tensor by
tensor divisions: ``float / tensor`` is a reciprocal times the constant in
PyTorch, and ``tensor / float`` is the same on CUDA, either of which can
differ from true division in the last bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..constants import GAMMA, KB_SOLVER, MU0

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LLGSParams:
    """Device parameters read by the LLGS hot loop.

    Every field is a 0-dim or (B,) tensor; ``easy_axis`` is (3,) or (B, 3).
    ``plus_z`` states whether every easy axis is exactly +z, which lets the
    CUDA kernel take its specialized right-hand side. ``None`` means unknown:
    the kernel's wrapper then reads the axis back from the device to decide.
    """

    saturation_magnetization: Tensor  # Ms (A/m)
    damping: Tensor  # Gilbert damping alpha (dimensionless)
    uniaxial_anisotropy: Tensor  # K_u (J/m^3)
    volume: Tensor  # V (m^3)
    polarization: Tensor  # spin polarization P (dimensionless)
    easy_axis: Tensor  # unit vector, (3,) or (B, 3)
    plus_z: Optional[bool] = None

    def to(self, device=None, dtype=None) -> "LLGSParams":
        def conv(x):
            return torch.as_tensor(x).to(device=device, dtype=dtype)

        return dataclasses.replace(
            self,
            **{f.name: conv(getattr(self, f.name)) for f in _TENSOR_FIELDS},
        )

    def normalized_easy_axis(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Unit easy-axis components."""
        e = self.easy_axis
        ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
        norm = torch.sqrt(ex * ex + ey * ey + ez * ez)
        return ex / norm, ey / norm, ez / norm


_TENSOR_FIELDS = [f for f in dataclasses.fields(LLGSParams) if f.name != "plus_z"]


def _rdiv(num: float, den: Tensor) -> Tensor:
    """``num / den`` by true division."""
    return torch.full_like(den, num) / den


def cross(ax, ay, az, bx, by, bz):
    """Component-wise cross product a x b (np.cross term order)."""
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _field(mx, my, mz, ms, h_k, ex, ey, ez, h_applied=None, h_thermal=None):
    """H_eff with the JAX package's addition order; ``None`` terms are 0."""
    m_dot_e = mx * ex + my * ey + mz * ez
    anis = h_k * m_dot_e
    hx, hy, hz = anis * ex, anis * ey, anis * ez
    if h_applied is not None:
        hx, hy, hz = h_applied[0] + hx, h_applied[1] + hy, h_applied[2] + hz
    # Thin-film shape anisotropy acts on z only: H_demag = -Ms m_z z_hat.
    hz = hz - ms * mz
    if h_thermal is not None:
        hx, hy, hz = hx + h_thermal[0], hy + h_thermal[1], hz + h_thermal[2]
    return hx, hy, hz


def effective_field(mx, my, mz, params: LLGSParams, h_applied=None, h_thermal=None):
    """Effective field H_eff = H_app + H_anis + H_demag + H_thermal."""
    ms = params.saturation_magnetization
    h_k = (2.0 * params.uniaxial_anisotropy) / (MU0 * ms)
    ex, ey, ez = params.normalized_easy_axis()
    return _field(mx, my, mz, ms, h_k, ex, ey, ez, h_applied, h_thermal)


def thermal_field_strength(params: LLGSParams, temperature) -> Tensor:
    """RMS thermal field amplitude of the reference solver:
    sigma = sqrt(2 alpha k_B T / (mu0 Ms V gamma)), with no 1/sqrt(dt)."""
    ms = params.saturation_magnetization
    return torch.sqrt(
        2.0 * params.damping * KB_SOLVER * temperature / (MU0 * ms * params.volume * GAMMA)
    )


class Coefficients(NamedTuple):
    """Per-env loop invariants of ``dmdt``, computed once per pulse."""

    ms: Tensor
    alpha: Tensor
    ex: Tensor
    ey: Tensor
    ez: Tensor
    h_k: Tensor  # 2 K_u / (mu0 Ms)
    neg_gamma_eff: Tensor  # -gamma / (1 + alpha^2)
    stt: Tensor  # P J / (Ms V), 0 where |J| <= 1e-12


def coefficients(current, params: LLGSParams) -> Coefficients:
    """The loop invariants of ``dmdt`` for a current density J (0-dim or (B,))."""
    alpha = params.damping
    ms = params.saturation_magnetization
    current = torch.as_tensor(current, dtype=ms.dtype, device=ms.device)
    ex, ey, ez = params.normalized_easy_axis()
    h_k = (2.0 * params.uniaxial_anisotropy) / (MU0 * ms)
    stt = params.polarization * current / (ms * params.volume)
    stt = torch.where(current.abs() > 1e-12, stt, 0.0)
    gamma_eff = _rdiv(GAMMA, 1.0 + alpha * alpha)
    return Coefficients(ms, alpha, ex, ey, ez, h_k, -gamma_eff, stt)


def dmdt_from(mx, my, mz, c: Coefficients, h_applied=None, h_thermal=None):
    """dm/dt from precomputed coefficients; the same bits as ``dmdt``."""
    hx, hy, hz = _field(mx, my, mz, c.ms, c.h_k, c.ex, c.ey, c.ez, h_applied, h_thermal)
    ux, uy, uz = cross(mx, my, mz, c.ex, c.ey, c.ez)  # m x e
    vx, vy, vz = cross(mx, my, mz, ux, uy, uz)  # m x (m x e)
    px, py, pz = cross(mx, my, mz, hx, hy, hz)  # precession m x H
    dx, dy, dz = cross(mx, my, mz, px, py, pz)  # m x (m x H)
    out_x = c.neg_gamma_eff * (px + c.alpha * dx) + c.stt * vx
    out_y = c.neg_gamma_eff * (py + c.alpha * dy) + c.stt * vy
    out_z = c.neg_gamma_eff * (pz + c.alpha * dz) + c.stt * vz
    return out_x, out_y, out_z


def dmdt(mx, my, mz, current, params: LLGSParams, h_applied=None, h_thermal=None):
    """LLGS time derivative dm/dt; ``current`` is J (A/m^2), 0-dim or (B,).

    The spin-transfer torque is gated on |J| > 1e-12."""
    return dmdt_from(mx, my, mz, coefficients(current, params), h_applied, h_thermal)


def normalize_with_fallback(mx, my, mz):
    """Normalize m, falling back to +z for non-finite or near-zero vectors:
    NaN/Inf or |m| < 1e-12 maps to [0, 0, 1]. True division throughout."""
    norm = torch.sqrt(mx * mx + my * my + mz * mz)
    finite = torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(mz)
    ok = finite & (norm >= 1e-12)
    safe_norm = torch.where(ok, norm, 1.0)
    nx, ny, nz = mx / safe_norm, my / safe_norm, mz / safe_norm
    ok = ok & torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz)
    return torch.where(ok, nx, 0.0), torch.where(ok, ny, 0.0), torch.where(ok, nz, 1.0)


def energy_density(mx, my, mz, params: LLGSParams, h_applied=(0.0, 0.0, 0.0)):
    """Single-domain magnetic energy density (J/m^3): Zeeman + uniaxial +
    thin-film demag."""
    ms = params.saturation_magnetization
    k_u = params.uniaxial_anisotropy
    ex, ey, ez = params.normalized_easy_axis()
    m_dot_e = mx * ex + my * ey + mz * ez
    zeeman = -MU0 * ms * (mx * h_applied[0] + my * h_applied[1] + mz * h_applied[2])
    anis = -k_u * m_dot_e * m_dot_e
    demag = 0.5 * MU0 * ms * ms * mz * mz
    return zeeman + anis + demag
