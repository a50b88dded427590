"""The LLGS pulse kernel on CUDA: its gate, probe, wrapper and launch counts.

Counterpart of ``spintorque_tpu/ops/pallas_integrator.py``. The kernel
(``csrc/pulse_integrator.cu``) replaces the Pallas kernel ``_kernel`` and
``integrate_pulse_cuda`` replaces its host side (``_pallas_core``): the dt
law and clamp, the per-env coefficients, the descending-n sort, the launch.
The kernel reads and writes env ``perm[t]`` from thread t, so no gather or
unsort pass is needed. The kernel's plain version is
``physics.integrator.integrate_pulse_plain``.

Dispatch is by device: ``physics.integrator.integrate_pulse`` sends CUDA
tensors here, and this wrapper launches the kernel or raises. It never falls
back to the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..physics.integrator import (
    IntegratorConfig,
    PulseResult,
    check_config,
    clamped_substep_counts,
    noise_draws,
    noise_sigma,
)
from ..physics.llgs import LLGSParams, coefficients
from . import _build
from .philox import seed_key

Tensor = torch.Tensor

# Threads per block. One thread per env; B=4096 fills only 128 warps, so
# small blocks spread them over more SMs.
PULSE_BLOCK = 64
_METHODS = {"euler": 0, "heun": 1, "rk4": 2}


class LaunchCounter:
    """Counts the launches of one kernel (a plain integer)."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


PULSE_LAUNCHES = LaunchCounter()
PROBE_LAUNCHES = LaunchCounter()


def _axis_on_host(easy_axis) -> torch.Tensor:
    return torch.as_tensor(easy_axis).detach().to("cpu", torch.float64).reshape(-1, 3)


def is_plus_z(easy_axis) -> bool:
    """True when every easy axis is exactly +z (reads the axis to the host)."""
    e = _axis_on_host(easy_axis)
    return bool(((e[:, 0].abs() < 1e-12) & (e[:, 1].abs() < 1e-12) & (e[:, 2] > 0)).all())


def cuda_supported(params: LLGSParams, config: IntegratorConfig, dtype) -> bool:
    """Whether the kernel covers this configuration: float32, a known method,
    no bf16 stage arithmetic, and a finite nonzero easy axis (read to the
    host, so call it once at build time, not per step)."""
    if config.method not in _METHODS or config.bf16_rhs:
        return False
    if dtype != torch.float32:
        return False
    e = _axis_on_host(params.easy_axis)
    return bool(torch.isfinite(e).all() and (torch.linalg.vector_norm(e, dim=-1) > 1e-12).all())


_PROBE_PASSED = False


def cuda_kernel_available() -> bool:
    """False without a CUDA device. Otherwise builds the kernel library
    (once), launches the probe kernel once, checks its result and caches
    True; raises when the build or the probe fails."""
    global _PROBE_PASSED
    if not torch.cuda.is_available():
        return False
    if _PROBE_PASSED:
        return True
    _build.load_library()
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda")
    y = probe_add_one(x)
    torch.cuda.synchronize()
    if not torch.equal(y, probe_add_one_plain(x)):
        raise RuntimeError("CUDA probe kernel returned a wrong result")
    _PROBE_PASSED = True
    return True


def forget_probe() -> None:
    """Drop the cached probe result, so the next ``cuda_kernel_available``
    probes again as a fresh process would."""
    global _PROBE_PASSED
    _PROBE_PASSED = False


def probe_add_one_plain(x: Tensor) -> Tensor:
    """The probe kernel's plain version."""
    return x + 1.0


def probe_add_one(x: Tensor) -> Tensor:
    """``x + 1`` by the probe kernel, on a contiguous float32 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError("probe_add_one takes a CUDA tensor")
    _check_tensor("x", x, x.device, x.shape)
    if x.numel() == 0:
        raise ValueError("probe_add_one: empty tensor")
    lib = _build.load_library().lib
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.spintorque_probe_add_one(x.data_ptr(), y.data_ptr(), x.numel(), stream)
        PROBE_LAUNCHES.count += 1
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {rc}")
    return y


def _check_tensor(name: str, t, device, shape, dtype=torch.float32) -> None:
    if not isinstance(t, Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _per_env(t: Tensor, batch: int) -> Tensor:
    """A 0-dim or (B,) coefficient as a contiguous (B,) tensor."""
    return torch.broadcast_to(t, (batch,)).contiguous()


def integrate_pulse_cuda(
    m0: Tuple[Tensor, Tensor, Tensor],
    span: Tensor,
    current: Tensor,
    params: LLGSParams,
    config: IntegratorConfig,
    seed: Optional[int] = None,
    temperature=300.0,
) -> PulseResult:
    """``physics.integrator.integrate_pulse`` by the CUDA kernel.

    Takes contiguous float32 (B,) CUDA tensors for m0's components, span and
    current; params fields on the same device, 0-dim or (B,) ((3,) or (B, 3)
    for the easy axis). Raises on anything else, on an unknown method and on
    ``bf16_rhs``. Launches on the current stream and does not synchronize;
    it reads nothing back from the device unless ``params.plus_z`` is None.
    """
    check_config(config)
    mx0, my0, mz0 = m0
    if not isinstance(mx0, Tensor) or mx0.device.type != "cuda":
        raise ValueError("integrate_pulse_cuda takes CUDA tensors")
    device = mx0.device
    batch = mx0.shape[0] if mx0.dim() == 1 else -1
    for name, t in (("mx0", mx0), ("my0", my0), ("mz0", mz0), ("span", span), ("current", current)):
        _check_tensor(name, t, device, (batch,))
    if config.thermal and seed is None:
        raise ValueError("integrate_pulse: thermal=True requires a seed")
    plus_z = params.plus_z if params.plus_z is not None else is_plus_z(params.easy_axis)

    dt, n = clamped_substep_counts(span, config)
    c = coefficients(current, params)
    per_env = {
        "h_k": c.h_k, "ms": c.ms, "neg_gamma_eff": c.neg_gamma_eff,
        "alpha": c.alpha, "stt": c.stt,
    }
    if not plus_z:
        per_env.update(ex=c.ex, ey=c.ey, ez=c.ez)
    if config.thermal:
        per_env["sigma"] = noise_sigma(params, temperature, dt, config)
    per_env = {k: _per_env(v, batch) for k, v in per_env.items()}
    for k, v in per_env.items():
        _check_tensor(k, v, device, (batch,))

    # Descending n: a warp then holds envs of similar length and runs to
    # its own longest. Thread t integrates env perm[t] in place of a
    # gather before the kernel and an unsort after it.
    perm = torch.argsort(-n, stable=True)
    mx = torch.empty_like(mx0)
    my = torch.empty_like(mx0)
    mz = torch.empty_like(mx0)
    failed = torch.empty((batch,), dtype=torch.bool, device=device)
    seed_lo, seed_hi = seed_key(seed if config.thermal else 0)

    def ptr(name):
        t = per_env.get(name)
        return None if t is None else t.data_ptr()

    lib = _build.load_library().lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.spintorque_pulse_integrate(
            mx0.data_ptr(), my0.data_ptr(), mz0.data_ptr(), n.data_ptr(), dt.data_ptr(),
            ptr("sigma"), ptr("h_k"), ptr("ms"), ptr("neg_gamma_eff"), ptr("alpha"), ptr("stt"),
            ptr("ex"), ptr("ey"), ptr("ez"), perm.data_ptr(),
            mx.data_ptr(), my.data_ptr(), mz.data_ptr(), failed.data_ptr(),
            batch, _METHODS[config.method], int(config.thermal),
            int(noise_draws(config) == 3), int(plus_z), seed_lo, seed_hi, PULSE_BLOCK, stream,
        )
        PULSE_LAUNCHES.count += 1
    if rc != 0:
        raise RuntimeError(f"pulse kernel launch failed: cudaError {rc}")
    return PulseResult(m=(mx, my, mz), n_substeps=n, dt=dt, failed=failed)
