"""Fixed-step batched LLGS pulse integrator.

PyTorch counterpart of ``spintorque_tpu/physics/integrator.py``. Each env
computes its own (dt, n_substeps) from the reference step-size law

    dt0 = min(max_step, span / 100)
    n   = max(10, int(span / dt0))
    dt  = span / n

and advances n substeps; an env whose n is below the running index holds
its state (the masked loop). The carried state is flushed of float
subnormals on entry and after every substep (``flush_subnormal``), a
narrower flush than XLA's (see there).

``integrate_pulse`` dispatches on the device of the magnetization tensors:
CUDA tensors go to the hand-written kernel (``ops/cuda_integrator.py``),
CPU tensors to ``integrate_pulse_plain``, the kernel's plain version, which
loops in Python to the batch's largest n. There is no fallback from one to
the other. ``integrate_pulse_trajectory`` runs that plain loop on any
device and records every substep's state.

Thermal noise modes:
  * 'reference' - per-field-evaluation white field with Brown's sigma and NO
    1/sqrt(dt) scaling, as the reference solver does.
  * 'physical' - sqrt(2 alpha k_B T / (gamma mu0 Ms V dt)), the consistent
    discretization of Brown's model; best paired with method='heun'.
The noise comes from the counter-based Philox stream of ``ops/philox.py``,
keyed by a 64-bit seed, which the kernel draws bit for bit the same. Its
counter holds the env's global index: ``env_offset`` plus the env's index
in the batch, so a shard of a batch (``env_offset`` = the shard's first
row) draws exactly its rows of the unsharded stream.

``bf16_rhs`` runs the stage arithmetic in bfloat16, as the JAX package's
Pallas kernel does: the coefficients, dt, a bf16 copy of the state and the
thermal field (sigma * normal in the state's dtype, then cast) enter every
stage in bf16, and each op rounds to bf16 as a torch bf16 op does. The
increment is widened and added to the carried state, which is normalized
in full precision. The plain version runs this on the CPU too, where the
JAX package's XLA path ignores ``bf16_rhs`` and computes in float32; the
JAX bf16 kernel in interpret mode keeps some intermediates in float32, so
the two agree in distribution, not bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..constants import GAMMA, KB_SOLVER, MU0
from ..ops import philox
from ..utils.profiling import count_on_device, tracing_enabled
from ..utils.profiling import span as trace_span
from .llgs import Coefficients, LLGSParams, coefficients, dmdt_from, normalize_with_fallback

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
    # bf16 stage arithmetic with the state carry, accumulation and
    # normalize in full precision (the module docstring).
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


def check_env_offset(env_offset: int, batch: int) -> None:
    """Raise unless every global env index env_offset + b, b < batch, fits
    the uint32 word of the Philox counter."""
    if not 0 <= env_offset <= 2**32 - batch:
        raise ValueError(
            f"env_offset {env_offset} + batch {batch} exceeds the 2^32 env indices "
            "of the thermal stream"
        )


def _increment(m, dt, c, method: str, stage):
    """One substep's increment of m, in the dtype of ``m``, ``dt`` and ``c``.

    ``stage`` holds the thermal field of each RK stage (None when
    deterministic); Euler and Heun use stage 0 for every evaluation."""
    mx, my, mz = m

    def rhs(ax, ay, az, s):
        return dmdt_from(ax, ay, az, c, h_thermal=None if stage is None else stage[s])

    if method == "euler":
        fx, fy, fz = rhs(mx, my, mz, 0)
        return dt * fx, dt * fy, dt * fz
    if method == "heun":
        # Stochastic Heun: the corrector reuses the predictor's noise.
        fx, fy, fz = rhs(mx, my, mz, 0)
        gx, gy, gz = rhs(mx + dt * fx, my + dt * fy, mz + dt * fz, 0)
        half_dt = 0.5 * dt
        return half_dt * (fx + gx), half_dt * (fy + gy), half_dt * (fz + gz)
    six = torch.full_like(dt, 6.0)
    k1x, k1y, k1z = rhs(mx, my, mz, 0)
    k1x, k1y, k1z = dt * k1x, dt * k1y, dt * k1z
    k2x, k2y, k2z = rhs(mx + k1x / 2, my + k1y / 2, mz + k1z / 2, 1)
    k2x, k2y, k2z = dt * k2x, dt * k2y, dt * k2z
    k3x, k3y, k3z = rhs(mx + k2x / 2, my + k2y / 2, mz + k2z / 2, 2)
    k3x, k3y, k3z = dt * k3x, dt * k3y, dt * k3z
    k4x, k4y, k4z = rhs(mx + k3x, my + k3y, mz + k3z, 3)
    k4x, k4y, k4z = dt * k4x, dt * k4y, dt * k4z
    return (
        (k1x + 2 * k2x + 2 * k3x + k4x) / six,
        (k1y + 2 * k2y + 2 * k3y + k4y) / six,
        (k1z + 2 * k2z + 2 * k3z + k4z) / six,
    )


def flush_subnormal(x: Tensor) -> Tensor:
    """``x`` with every subnormal element (magnitude below the smallest
    normal of its dtype) replaced by a zero of its sign, as XLA's
    flush-to-zero gives: a compare, a product by 0 and a select. The kernel
    (``csrc/llgs_substep.cuh``) flushes its first state the same way, the
    zero a bit operation, and each new state, always finite, with one
    multiply by 1 under the hardware's flush-to-zero, which gives the same
    bits. XLA flushes subnormals on the CPU and on a
    TPU, so the JAX package's pulse holds a pole state with subnormal
    transverse components at the pole, a fixed point, where IEEE arithmetic
    would let a destabilizing current grow them by ~e^58 over a few hundred
    substeps.

    This flush is narrower than XLA's: it touches only the carried state
    (XLA's also flushes every intermediate, the stage states and the
    right-hand side's products). The adaptive integrators
    (``physics/adaptive.py``) and the array env's sweeps (``envs/array.py``)
    flush their carried states with it too. Parity with JAX, the sign bit
    of every component included, is shown for pole states and states
    decaying through the subnormal range (``tests/test_torch_research_tier.py``,
    ``tests/test_torch_subnormal_parity.py``), not in general."""
    # x * 0 is the zero of x's sign wherever it is selected (finite x).
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, x * 0.0, x)


def _substep(m, dt, c, method: str, stage, stage_dtype):
    """One integration substep: the increment, computed in ``stage_dtype``
    (``dt``, ``c`` and ``stage`` already are), added to the carried state,
    then normalize-with-fallback and the subnormal flush."""
    mx, my, mz = m
    sm = tuple(x.to(stage_dtype) for x in m)
    dx, dy, dz = _increment(sm, dt, c, method, stage)
    n = normalize_with_fallback(mx + dx.to(mx.dtype), my + dy.to(my.dtype),
                                mz + dz.to(mz.dtype))
    return tuple(flush_subnormal(x) for x in n)


def _stage_fields(normals: Tensor, sigma: Tensor, config: IntegratorConfig, stage_dtype):
    """Thermal field of each RK stage from one substep's (4 * draws, B)
    normals: stage s of per-stage RK4 takes normals 3s..3s+2, every other
    case takes normals 0..2 for all its stages. sigma * normal is taken in
    the normals' dtype, then cast to ``stage_dtype``."""
    per_stage = noise_draws(config) == 3
    n_stages = _N_STAGES[config.method]
    fields = []
    for s in range(n_stages):
        o = 3 * s if per_stage else 0
        fields.append(tuple((sigma * normals[o + k]).to(stage_dtype) for k in range(3)))
    return fields


def integrate_pulse_plain(
    m0: Tuple[Tensor, Tensor, Tensor],
    span: Tensor,
    current: Tensor,
    params: LLGSParams,
    config: IntegratorConfig,
    seed: Optional[int] = None,
    temperature=300.0,
    env_offset: int = 0,
) -> PulseResult:
    """The pulse kernel's plain PyTorch version, on any device.

    Loops to the batch's largest n (one host read of n) and masks envs whose
    n is reached. ``seed`` keys the Philox thermal stream (required when
    ``config.thermal``); the counter of env b's draw d at substep i is
    (env_offset + b, i, d, 0), exactly as the kernel counts it.
    """
    return _plain_loop(m0, span, current, params, config, seed, temperature, env_offset)[0]


def integrate_pulse_trajectory(
    m0: Tuple[Tensor, Tensor, Tensor],
    span: Tensor,
    current: Tensor,
    params: LLGSParams,
    config: IntegratorConfig,
    seed: Optional[int] = None,
    temperature=300.0,
) -> Tuple[PulseResult, Tensor]:
    """Like ``integrate_pulse``, and records the state after every substep.

    Returns (PulseResult, trajectory): the trajectory is (max_substeps + 1,
    3, B), row 0 the initial state and row i + 1 the state after substep
    i; an env past its n repeats its held state, as in the JAX package's
    fixed-length scan. The plain loop of ``integrate_pulse_plain`` (the same
    substeps, the same Philox draws) on any device, in any dtype: it stops
    at the batch's largest n and fills the rows after it with the final
    state. An analysis path: no kernel runs it. It is differentiable
    (``current``, ``span``, ``m0``), as the JAX scan is under ``jax.grad``:
    the optimal-control baseline of ``research.comparative_algorithms``
    descends through it.
    """
    return _plain_loop(m0, span, current, params, config, seed, temperature, 0, trajectory=True)


def _plain_loop(m0, span, current, params, config, seed, temperature, env_offset,
                trajectory=False):
    """The plain masked substep loop: (PulseResult, the (max_substeps + 1,
    3, B) trajectory when ``trajectory``, else None)."""
    check_config(config)
    mx, my, mz = m0
    dtype = mx.dtype
    span = torch.as_tensor(span, dtype=dtype, device=mx.device)
    current = torch.as_tensor(current, dtype=dtype, device=mx.device)
    mx, my, mz, span, current = torch.broadcast_tensors(mx, my, mz, span, current)
    mx, my, mz = flush_subnormal(mx), flush_subnormal(my), flush_subnormal(mz)
    check_env_offset(env_offset, mx.shape[0])
    params = params.to(dtype=dtype)

    dt, n = clamped_substep_counts(span, config)
    n_max = int(n.max()) if n.numel() else 0
    stage_dtype = torch.bfloat16 if config.bf16_rhs else dtype
    # Cast once: the cast of a loop invariant is the same every substep.
    c_stage = Coefficients(*(x.to(stage_dtype) for x in coefficients(current, params)))
    dt_stage = dt.to(stage_dtype)

    sigma = None
    if config.thermal:
        if seed is None:
            raise ValueError("integrate_pulse: thermal=True requires a seed")
        sigma = noise_sigma(params, temperature, dt, config)
        env_index = env_offset + torch.arange(mx.shape[0], device=mx.device)
        draws = noise_draws(config)

    failed = torch.zeros(mx.shape, dtype=torch.bool, device=mx.device)
    # The recorded states, stacked once at the end: writing each into a
    # preallocated tensor (``out=``) would cut the autograd graph.
    states = [torch.stack((mx, my, mz))] if trajectory else None
    normals = None
    for i in range(n_max):
        stage = None
        if sigma is not None:
            j = i % _NOISE_CHUNK
            if j == 0:
                steps = torch.arange(i, min(i + _NOISE_CHUNK, n_max), device=mx.device)
                normals = philox.substep_normals(seed, env_index, steps, draws, dtype)
            stage = _stage_fields(normals[j], sigma, config, stage_dtype)
        nx, ny, nz = _substep((mx, my, mz), dt_stage, c_stage, config.method, stage, stage_dtype)
        active = i < n
        zero_row = active & (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
        mx = torch.where(active, nx, mx)
        my = torch.where(active, ny, my)
        mz = torch.where(active, nz, mz)
        failed = failed | zero_row
        if states is not None:
            states.append(torch.stack((mx, my, mz)))
    traj = None
    if states is not None:
        held = config.max_substeps - n_max
        if held > 0:  # the rows after n_max repeat the final state
            states.append(states[-1].expand((held,) + states[-1].shape))
        traj = torch.cat([x.reshape((-1,) + states[0].shape) for x in states])
    return PulseResult(m=(mx, my, mz), n_substeps=n, dt=dt, failed=failed), traj


def integrate_pulse(
    m0: Tuple[Tensor, Tensor, Tensor],
    span: Tensor,
    current: Tensor,
    params: LLGSParams,
    config: IntegratorConfig,
    seed: Optional[int] = None,
    temperature=300.0,
    *,
    mesh=None,
) -> PulseResult:
    """Advance a batch of magnetizations through one square current pulse.

    Args:
        m0: magnetization components (mx, my, mz), each (B,).
        span: (B,) pulse durations (s), already clipped > 0.
        current: (B,) current densities J (A/m^2), constant over the pulse.
        params: LLGSParams with 0-dim or (B,) fields.
        config: IntegratorConfig.
        seed: 64-bit key of the Philox thermal stream (required when
            config.thermal); on CUDA also a 0-dim int64 tensor on the
            device holding it (``ops.cuda_integrator.pulse_key``), as a
            captured env step passes it.
        temperature: float or (B,) tensor, Kelvin.
        mesh: the ``parallel.Mesh`` whose 'data' shard this batch is (B is
            then the rank's local batch); its thermal draws are keyed from
            the shard's first global row,
            ``ops.cuda_integrator.shard_env_offset``. A batch that the mesh
            replicates runs with ``parallel.split_mesh(B, mesh)``, which is
            None: unsharded on every rank, as the JAX package's
            ``integrate_pulse_pallas`` falls back
            (``spintorque_tpu/ops/pallas_integrator.py:639-646``).

    CUDA tensors run the hand-written kernel (K5, the sharded launch, on a
    mesh; K1 or K6 otherwise) and CPU tensors its plain version; any other
    device raises. Each shard sorts its own
    envs by n, and its thermal draws are its rows of the unsharded stream,
    so a sharded pulse equals the unsharded one bit for bit.

    Runs inside the span ``integrator.pulse``; with tracing on it keeps the
    result for the device count ``pulse.plus_z_rows``, the rows that end
    exactly at +z (the fallback's value), counted when the counts are read.
    """
    from ..ops.cuda_integrator import integrate_pulse_cuda, shard_env_offset

    sharded = mesh is not None
    env_offset = shard_env_offset(mesh.data_rank, m0[0].shape[0]) if sharded else 0
    device = m0[0].device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"integrate_pulse runs on cuda or cpu tensors, not {device}")
    with trace_span("integrator.pulse"):
        if device.type == "cuda":
            res = integrate_pulse_cuda(m0, span, current, params, config, seed, temperature,
                                       env_offset=env_offset, sharded=sharded)
        else:
            res = integrate_pulse_plain(m0, span, current, params, config, seed, temperature,
                                        env_offset=env_offset)
    count_plus_z_rows(res.m)
    return res


def count_plus_z_rows(m: Tuple[Tensor, Tensor, Tensor]) -> None:
    """With tracing on, keeps a pulse's result ``m`` for the device count
    ``pulse.plus_z_rows`` (a captured env step's replays pass their owned
    copy of it)."""
    if tracing_enabled():
        count_on_device("pulse.plus_z_rows", _plus_z_rows, m)


def _plus_z_rows(mx: Tensor, my: Tensor, mz: Tensor) -> Tensor:
    """The rows of pulse results that are exactly (0, 0, 1)."""
    return ((mx == 0) & (my == 0) & (mz == 1)).sum()
