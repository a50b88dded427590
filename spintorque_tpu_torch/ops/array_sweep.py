"""The array env's sequential sweep (SpinTorqueArray-v0,
``coupling_update='sequential'``): the CUDA kernel ``csrc/array_sweep.cu``
and its plain version.

The sweep updates the devices of every array one after another, device d
seeing devices < d already updated through the coupling field, each by the
reference's inline 10-substep Euler; it returns the new (B, N, 3) pattern
and the (B,) step energy. ``sequential_sweep_plain`` is the eager body
that ``envs/array.py`` ran before the kernel, over the device law of
``physics/array_law.py``: ~120 launches a device over all B rows. ``sequential_sweep`` runs the same sweep in one launch: the
per-device energies ``pulse_energy(J, dt, resistance(flushed m))`` come
first, one elementwise pass over (B, N) with ``devices/resistance.py``'s
functions (the plain version's bits, element by element, and every device
type's resistance law in one place), then the kernel flushes the pattern,
sweeps, and sums the energies in device order.

No TPU kernel stands behind this one: the JAX package's sweep is a masked
``lax.scan`` that XLA compiles whole. The kernel mirrors the plain
version's op order; where PyTorch leaves the order open (the cross
product's contraction, the dot with the easy axis, the coupling einsum,
|m|^2) it takes the one PyTorch was found to take on the card, and the
card tests hold it to the plain version at 1e-6 and report its bits.

``SpinTorqueArrayEnv`` picks the route once, at construction: the kernel
for a float32 env on a CUDA device, the plain version otherwise (the CPU,
and other dtypes on the card). The host counters ``array.sweep_kernels``
and ``array.sweep_eager`` count the sweeps each route ran.
"""

from __future__ import annotations

import torch

from . import _build
from ..constants import MU0
from ..devices.params import DeviceParams
from ..devices.resistance import pulse_energy as _pulse_energy
from ..devices.resistance import resistance as _resistance
from ..physics.array_law import HARDCODED_GAMMA, device_field, device_update
from ..physics.integrator import flush_subnormal
from ..utils.profiling import counter

Tensor = torch.Tensor

SWEEP_KERNELS = counter("array.sweep_kernels")  # kernel launches
SWEEP_EAGER = counter("array.sweep_eager")  # sweeps run by the plain version


def sequential_sweep_plain(pattern, mask, current, duration, coupling, easy_axis,
                           params: DeviceParams, device_type: str):
    """The kernel's plain version. Device d sees devices < d already
    updated; one copy of the pattern per step, flushed of subnormals, takes
    every device's result; the devices it does not move keep their
    unflushed input."""
    SWEEP_EAGER.add()
    p_hat = torch.zeros_like(easy_axis)
    p_hat[2].fill_(1.0)  # on the device: a CUDA graph may capture the sweep
    held = pattern
    pattern = flush_subnormal(pattern)
    energy = torch.zeros_like(current)
    for d in range(pattern.shape[1]):
        m_d = pattern[:, d, :]
        h = device_field(pattern, d, coupling, easy_axis, params)
        m_new = device_update(m_d, h, current, duration, p_hat)
        active = mask[:, d]
        m_out = torch.where(active[:, None], m_new, m_d)
        r = _resistance(device_type, m_d[:, 0], m_d[:, 1], m_d[:, 2], params)
        e = _pulse_energy(current, duration, r, params.area)
        energy = energy + torch.where(active, e, 0.0)
        pattern[:, d, :] = m_out  # last: m_d views this row
    moved = mask & (current.abs() > 1e-12)[:, None]
    return torch.where(moved[..., None], pattern, held), energy


def _check(pattern, mask, current, duration, coupling, easy_axis, params: DeviceParams):
    """(B, N) of the kernel's inputs; raises on what it does not take."""
    tensors = dict(pattern=pattern, mask=mask, current=current, duration=duration,
                   coupling=coupling, easy_axis=easy_axis,
                   uniaxial_anisotropy=params.uniaxial_anisotropy,
                   saturation_magnetization=params.saturation_magnetization, area=params.area)
    for name, t in tensors.items():
        if not isinstance(t, Tensor) or t.device.type != "cuda":
            raise ValueError(f"sequential_sweep takes CUDA tensors; {name} is not one")
        if t.device != pattern.device:
            raise ValueError(f"sequential_sweep: {name} is on {t.device}, the pattern on "
                             f"{pattern.device}")
        want = torch.bool if name == "mask" else torch.float32
        if t.dtype != want:
            raise ValueError(f"sequential_sweep takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sequential_sweep takes a contiguous {name}")
    if pattern.ndim != 3 or pattern.shape[-1] != 3 or pattern.shape[0] == 0 \
            or pattern.shape[1] == 0:
        raise ValueError(f"sequential_sweep takes a nonempty (B, N, 3) pattern, got "
                         f"{tuple(pattern.shape)}")
    B, N = pattern.shape[:2]
    shapes = dict(mask=(B, N), current=(B,), duration=(B,), coupling=(N, N), easy_axis=(3,),
                  uniaxial_anisotropy=(), saturation_magnetization=(), area=())
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"sequential_sweep: {name} has shape "
                             f"{tuple(tensors[name].shape)}, not {shape}")
    return B, N


def sequential_sweep(pattern, mask, current, duration, coupling, easy_axis,
                     params: DeviceParams, device_type: str):
    """The sequential sweep by the kernel: ``sequential_sweep_plain``'s
    arguments and results, on contiguous CUDA tensors (float32; the mask
    bool). Launches on the current stream, allocates only its outputs and
    the per-device energies, reads nothing back and does not synchronize;
    raises on a CPU tensor, another dtype, shape or a non-contiguous
    input."""
    B, N = _check(pattern, mask, current, duration, coupling, easy_axis, params)
    flushed = flush_subnormal(pattern)
    r = _resistance(device_type, flushed[..., 0], flushed[..., 1], flushed[..., 2], params)
    energies = _pulse_energy(current[:, None], duration[:, None], r, params.area).contiguous()
    out = torch.empty_like(pattern)
    energy = torch.empty_like(current)
    rc = _build.launch(
        _build.kernel_fn("spintorque_array_sweep"), pattern.device, pattern.data_ptr(),
        mask.data_ptr(), current.data_ptr(), duration.data_ptr(), energies.data_ptr(),
        coupling.data_ptr(), easy_axis.data_ptr(), params.uniaxial_anisotropy.data_ptr(),
        params.saturation_magnetization.data_ptr(), out.data_ptr(), energy.data_ptr(), B, N,
        -HARDCODED_GAMMA, MU0)
    if rc != 0:
        raise RuntimeError(f"array sweep kernel launch failed: cudaError {rc}")
    SWEEP_KERNELS.add()
    return out, energy
