"""The array env's inline device law (SpinTorqueArray-v0): the reference's
hardcoded damping and gyromagnetic ratio, the anisotropy field, and one
device's field and 10-substep constant-slope Euler update.

``envs/array.py`` (both coupling modes, the pattern sampler) and the
sequential sweep's plain version in ``ops/array_sweep.py`` read the law
from here.
"""

from __future__ import annotations

import torch

from ..constants import GAMMA, MU0
from ..devices.params import DeviceParams

Tensor = torch.Tensor

HARDCODED_ALPHA = 0.01
HARDCODED_GAMMA = GAMMA


def norm(v: Tensor) -> Tensor:
    """|v| over the last axis, keeping it."""
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def anisotropy_field(params: DeviceParams) -> Tensor:
    return 2.0 * params.uniaxial_anisotropy / (MU0 * params.saturation_magnetization)


def device_field(pattern: Tensor, d: int, coupling: Tensor, easy_axis: Tensor,
                 params: DeviceParams) -> Tensor:
    """Effective field of device d: the intrinsic anisotropy field and
    the coupling sum over the current (partly updated) pattern."""
    e = easy_axis
    cos_t = pattern[:, d, :] @ e
    h = anisotropy_field(params) * cos_t[:, None] * e[None, :]
    return h + torch.einsum("n,bnc->bc", coupling[d], pattern)


def device_update(m, h_eff, current, duration, p_hat):
    """Constant-slope 10-substep Euler."""
    tau = 0.1 * current[:, None] * cross(m, cross(m, p_hat.expand_as(m)))
    dmdt = -HARDCODED_GAMMA * cross(m, h_eff)
    dmdt = dmdt + HARDCODED_ALPHA * cross(m, dmdt)
    dmdt = dmdt + tau
    dt = (duration / 10.0)[:, None]
    out = m
    for _ in range(10):
        out = out + dmdt * dt
        out = out / norm(out)
    # Zero-current devices stay exactly put.
    return torch.where((current.abs() > 1e-12)[:, None], out, m)
