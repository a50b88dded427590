"""Fixed-step batched LLGS pulse integrator.

PyTorch counterpart of ``spintorque_tpu/physics/integrator.py``. Each env
computes its own (dt, n_substeps) from the reference step-size law

    dt0 = min(max_step, span / 100)
    n   = max(10, int(span / dt0))
    dt  = span / n

and advances n substeps; an env whose n is below the running index holds
its state (the masked loop).

``integrate_pulse`` dispatches on the device of the magnetization tensors:
CUDA tensors go to the hand-written kernel (``ops/cuda_integrator.py``),
CPU tensors to ``integrate_pulse_plain``, the kernel's plain version, which
loops in Python to the batch's largest n. There is no fallback from one to
the other.

Thermal noise modes:
  * 'reference' - per-field-evaluation white field with Brown's sigma and NO
    1/sqrt(dt) scaling, as the reference solver does.
  * 'physical' - sqrt(2 alpha k_B T / (gamma mu0 Ms V dt)), the consistent
    discretization of Brown's model; best paired with method='heun'.
The noise comes from the counter-based Philox stream of ``ops/philox.py``,
keyed by a 64-bit seed, which the kernel draws bit for bit the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..constants import GAMMA, KB_SOLVER, MU0
from ..ops import philox
from .llgs import LLGSParams, coefficients, dmdt_from, normalize_with_fallback

Tensor = torch.Tensor

_N_STAGES = {"euler": 1, "heun": 1, "rk4": 4}
# Substeps whose Philox normals the plain loop draws in one batch.
_NOISE_CHUNK = 64


class IntegratorConfig(NamedTuple):
    """Static integrator configuration."""

    method: str = "rk4"  # 'euler' | 'rk4' | 'heun'
    max_step: float = 1e-12  # reference max_step (s)
    max_substeps: int = 5120  # upper bound on the masked loop
    thermal: bool = False
    noise_mode: str = "reference"  # 'reference' | 'physical'
    # RK4 thermal-field sampling:
    #   'per_stage'   - a fresh iid field at every RHS evaluation, as the
    #                   reference draws inside each call.
    #   'per_substep' - one field realization held over the four stages
    #                   (the standard SDE treatment, as stochastic Heun).
    rk4_noise: str = "per_stage"
    # bf16 stage arithmetic: not ported yet (raises NotImplementedError).
    bf16_rhs: bool = False


def max_substeps_for(max_duration: float, max_step: float = 1e-12) -> int:
    """Substep bound for pulses up to ``max_duration`` under the dt law."""
    return max(10, int(math.ceil(max_duration / min(max_step, max_duration / 100.0))) + 1)


def substep_counts(span: Tensor, max_step: float) -> Tuple[Tensor, Tensor]:
    """Per-env (dt, n_substeps) from the reference step-size law (int()
    truncates toward zero, which is floor here).

    Both divisions are tensor by tensor: on CUDA PyTorch turns division by a
    Python float into a multiply by its reciprocal, and 0.01 is inexact, so
    ``span / 100.0`` could be 1 ulp off and flip n at integer boundaries of
    the quotient."""
    hundred = torch.full_like(span, 100.0)
    dt0 = torch.minimum(torch.full_like(span, max_step), span / hundred)
    n = torch.clamp_min(torch.floor(span / dt0).to(torch.int32), 10)
    dt = span / n.to(span.dtype)
    return dt, n


def clamped_substep_counts(span: Tensor, config: IntegratorConfig) -> Tuple[Tensor, Tensor]:
    """``substep_counts`` with n clamped to ``config.max_substeps``; dt is
    recomputed from the clamped n, so an out-of-budget pulse integrates its
    full span at a coarser dt (for in-range pulses it is bitwise the same)."""
    _, n = substep_counts(span, config.max_step)
    n = torch.clamp_max(n, config.max_substeps)
    return span / n.to(span.dtype), n


class PulseResult(NamedTuple):
    m: Tuple[Tensor, Tensor, Tensor]  # final components, each (B,)
    n_substeps: Tensor  # (B,) int32
    dt: Tensor  # (B,)
    failed: Tensor  # (B,) bool - a substep produced an all-zero row

    # ``failed`` reproduces the reference's freeze: an RK4 blow-up whose
    # squared norm overflows normalizes to an exact zero vector, the
    # reference discards that solve, and the env keeps its pre-step state.


def check_config(config: IntegratorConfig) -> None:
    """Raise on a configuration that no integrator of the port runs."""
    if config.bf16_rhs:
        raise NotImplementedError("bf16_rhs: the bf16 stage-arithmetic variant is not ported")
    if config.method not in _N_STAGES:
        raise ValueError(f"Unknown method: {config.method}")
    if config.thermal:
        if config.noise_mode not in ("reference", "physical"):
            raise ValueError(f"Unknown noise_mode: {config.noise_mode}")
        if config.rk4_noise not in ("per_stage", "per_substep"):
            raise ValueError(f"Unknown rk4_noise: {config.rk4_noise}")


def noise_sigma(params: LLGSParams, temperature, dt: Tensor, config: IntegratorConfig) -> Tensor:
    """Thermal field amplitude per env for the noise mode; 0 where T <= 0.

    ``temperature`` is a float or a tensor (0-dim or (B,))."""
    dtype = dt.dtype
    alpha = params.damping.to(dtype)
    ms = params.saturation_magnetization.to(dtype)
    vol = params.volume.to(dtype)
    denom = MU0 * ms * vol * GAMMA
    if config.noise_mode == "physical":
        sigma = torch.sqrt(2.0 * alpha * KB_SOLVER * temperature / (denom * dt))
    elif config.noise_mode == "reference":
        sigma = torch.sqrt(2.0 * alpha * KB_SOLVER * temperature / denom)
    else:
        raise ValueError(f"Unknown noise_mode: {config.noise_mode}")
    sigma = torch.broadcast_to(sigma, dt.shape)
    if isinstance(temperature, Tensor):
        return torch.where(temperature > 0.0, sigma, 0.0)
    return sigma if temperature > 0.0 else torch.zeros_like(sigma)


def noise_draws(config: IntegratorConfig) -> int:
    """Philox calls per substep: 3 for per-stage RK4 (12 normals, 3 per
    stage), else 1 (3 of its 4 normals)."""
    return 3 if (config.method == "rk4" and config.rk4_noise == "per_stage") else 1


def _substep(m, dt, c, method: str, stage):
    """One integration substep: advance + normalize-with-fallback.

    ``stage`` holds the thermal field of each RK stage (None when
    deterministic); Euler and Heun use stage 0 for every evaluation."""
    mx, my, mz = m

    def rhs(ax, ay, az, s):
        return dmdt_from(ax, ay, az, c, h_thermal=None if stage is None else stage[s])

    if method == "euler":
        fx, fy, fz = rhs(mx, my, mz, 0)
        nx, ny, nz = mx + dt * fx, my + dt * fy, mz + dt * fz
    elif method == "heun":
        # Stochastic Heun: the corrector reuses the predictor's noise.
        fx, fy, fz = rhs(mx, my, mz, 0)
        gx, gy, gz = rhs(mx + dt * fx, my + dt * fy, mz + dt * fz, 0)
        half_dt = 0.5 * dt
        nx = mx + half_dt * (fx + gx)
        ny = my + half_dt * (fy + gy)
        nz = mz + half_dt * (fz + gz)
    else:
        six = torch.full_like(dt, 6.0)
        k1x, k1y, k1z = rhs(mx, my, mz, 0)
        k1x, k1y, k1z = dt * k1x, dt * k1y, dt * k1z
        k2x, k2y, k2z = rhs(mx + k1x / 2, my + k1y / 2, mz + k1z / 2, 1)
        k2x, k2y, k2z = dt * k2x, dt * k2y, dt * k2z
        k3x, k3y, k3z = rhs(mx + k2x / 2, my + k2y / 2, mz + k2z / 2, 2)
        k3x, k3y, k3z = dt * k3x, dt * k3y, dt * k3z
        k4x, k4y, k4z = rhs(mx + k3x, my + k3y, mz + k3z, 3)
        k4x, k4y, k4z = dt * k4x, dt * k4y, dt * k4z
        nx = mx + (k1x + 2 * k2x + 2 * k3x + k4x) / six
        ny = my + (k1y + 2 * k2y + 2 * k3y + k4y) / six
        nz = mz + (k1z + 2 * k2z + 2 * k3z + k4z) / six
    return normalize_with_fallback(nx, ny, nz)


def _stage_fields(normals: Tensor, sigma: Tensor, config: IntegratorConfig):
    """Thermal field of each RK stage from one substep's (4 * draws, B)
    normals: stage s of per-stage RK4 takes normals 3s..3s+2, every other
    case takes normals 0..2 for all its stages."""
    per_stage = noise_draws(config) == 3
    n_stages = _N_STAGES[config.method]
    fields = []
    for s in range(n_stages):
        o = 3 * s if per_stage else 0
        fields.append((sigma * normals[o], sigma * normals[o + 1], sigma * normals[o + 2]))
    return fields


def integrate_pulse_plain(
    m0: Tuple[Tensor, Tensor, Tensor],
    span: Tensor,
    current: Tensor,
    params: LLGSParams,
    config: IntegratorConfig,
    seed: Optional[int] = None,
    temperature=300.0,
) -> PulseResult:
    """The pulse kernel's plain PyTorch version, on any device.

    Loops to the batch's largest n (one host read of n) and masks envs whose
    n is reached. ``seed`` keys the Philox thermal stream (required when
    ``config.thermal``); the counter of env b's draw d at substep i is
    (b, i, d, 0), exactly as the kernel counts it.
    """
    check_config(config)
    mx, my, mz = m0
    dtype = mx.dtype
    span = torch.as_tensor(span, dtype=dtype, device=mx.device)
    current = torch.as_tensor(current, dtype=dtype, device=mx.device)
    mx, my, mz, span, current = torch.broadcast_tensors(mx, my, mz, span, current)
    params = params.to(dtype=dtype)

    dt, n = clamped_substep_counts(span, config)
    n_max = int(n.max()) if n.numel() else 0
    c = coefficients(current, params)

    sigma = None
    if config.thermal:
        if seed is None:
            raise ValueError("integrate_pulse: thermal=True requires a seed")
        sigma = noise_sigma(params, temperature, dt, config)
        env_index = torch.arange(mx.shape[0], device=mx.device)
        draws = noise_draws(config)

    failed = torch.zeros(mx.shape, dtype=torch.bool, device=mx.device)
    normals = None
    for i in range(n_max):
        stage = None
        if sigma is not None:
            j = i % _NOISE_CHUNK
            if j == 0:
                steps = torch.arange(i, min(i + _NOISE_CHUNK, n_max), device=mx.device)
                normals = philox.substep_normals(seed, env_index, steps, draws, dtype)
            stage = _stage_fields(normals[j], sigma, config)
        nx, ny, nz = _substep((mx, my, mz), dt, c, config.method, stage)
        active = i < n
        zero_row = active & (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
        mx = torch.where(active, nx, mx)
        my = torch.where(active, ny, my)
        mz = torch.where(active, nz, mz)
        failed = failed | zero_row
    return PulseResult(m=(mx, my, mz), n_substeps=n, dt=dt, failed=failed)


def integrate_pulse(
    m0: Tuple[Tensor, Tensor, Tensor],
    span: Tensor,
    current: Tensor,
    params: LLGSParams,
    config: IntegratorConfig,
    seed: Optional[int] = None,
    temperature=300.0,
) -> PulseResult:
    """Advance a batch of magnetizations through one square current pulse.

    Args:
        m0: magnetization components (mx, my, mz), each (B,).
        span: (B,) pulse durations (s), already clipped > 0.
        current: (B,) current densities J (A/m^2), constant over the pulse.
        params: LLGSParams with 0-dim or (B,) fields.
        config: IntegratorConfig.
        seed: 64-bit key of the Philox thermal stream (required when
            config.thermal).
        temperature: float or (B,) tensor, Kelvin.

    CUDA tensors run the hand-written kernel and CPU tensors its plain
    version; any other device raises.
    """
    device = m0[0].device
    if device.type == "cuda":
        from ..ops.cuda_integrator import integrate_pulse_cuda

        return integrate_pulse_cuda(m0, span, current, params, config, seed, temperature)
    if device.type != "cpu":
        raise ValueError(f"integrate_pulse runs on cuda or cpu tensors, not {device}")
    return integrate_pulse_plain(m0, span, current, params, config, seed, temperature)
