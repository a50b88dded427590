"""Batched magnetics vector operations.

PyTorch counterpart of ``spintorque_tpu/physics/vector_ops.py``: the
standalone batched primitives (cross, dot, normalize, energy, TMR
resistance, anisotropy and thin-film demag fields) over (..., 3) tensors.
Parameters may be Python numbers, arrays or tensors; they are taken as
tensors of the magnetization's dtype on its device.
"""

from __future__ import annotations

import time

import torch

from ..constants import MU0

Tensor = torch.Tensor


def _like(x, ref: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def batch_cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over (..., 3) batches."""
    return torch.linalg.cross(a, torch.broadcast_to(b, a.shape), dim=-1)


def batch_dot(a: Tensor, b: Tensor) -> Tensor:
    """Dot product over (..., 3) -> (...)."""
    return torch.sum(a * b, dim=-1)


def batch_normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    """Safe normalization over (..., 3)."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp_min(norm, eps)


def batch_magnetic_energy(m: Tensor, h_applied, ms, k_u, volume, easy_axis) -> Tensor:
    """Zeeman + uniaxial energy per device."""
    e = batch_normalize(_like(easy_axis, m))
    ms, k_u, volume = (_like(x, m) for x in (ms, k_u, volume))
    zeeman = -MU0 * ms * volume * batch_dot(m, _like(h_applied, m))
    anis = -k_u * volume * batch_dot(m, e) ** 2
    return zeeman + anis


def batch_tmr_resistance(m: Tensor, reference_m, r_p, r_ap) -> Tensor:
    """TMR cosine resistance over batches."""
    cos_theta = batch_dot(m, batch_normalize(_like(reference_m, m)))
    r_p, r_ap = _like(r_p, m), _like(r_ap, m)
    r = r_p * (1.0 + ((r_ap - r_p) / r_p) * (1.0 - cos_theta) / 2.0)
    return torch.maximum(r, 0.5 * r_p)


def batch_anisotropy_field(m: Tensor, ms, k_u, easy_axis) -> Tensor:
    """H_anis = (2 K_u / mu0 Ms) (m.e) e over batches."""
    e = batch_normalize(_like(easy_axis, m))
    h_k = 2.0 * _like(k_u, m) / (MU0 * _like(ms, m))
    return (h_k * batch_dot(m, e))[..., None] * e


def batch_demag_field_thin_film(m: Tensor, ms) -> Tensor:
    """Thin-film H_demag = -Ms m_z z_hat over batches."""
    out = torch.zeros_like(m)
    out[..., 2] = -_like(ms, m) * m[..., 2]
    return out


def benchmark_batch_ops(batch_size: int = 4096, iters: int = 100, *, device=None,
                        generator: torch.Generator = None):
    """Self-benchmark: ``iters`` normalize(cross(a, b)) over (batch_size, 3)
    float32 normals drawn from ``generator`` on ``device`` (the card unless
    the caller asks for the CPU), timed by the host clock between
    synchronizations."""
    from ..parallel.mesh import resolve_device

    device = resolve_device(device, None)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((batch_size, 3), generator=generator, device=device)
    b = torch.randn((batch_size, 3), generator=generator, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = batch_cross(a, b)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = batch_normalize(batch_cross(a, b))
    sync()
    elapsed = time.perf_counter() - t0
    return {
        "batch_size": batch_size,
        "iters": iters,
        "total_s": elapsed,
        "ops_per_s": batch_size * iters / elapsed,
        "device": str(device),
    }
