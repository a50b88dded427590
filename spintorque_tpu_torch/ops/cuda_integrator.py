"""The LLGS pulse kernel on CUDA: its gate, probe, wrapper and launch counts.

Counterpart of ``spintorque_tpu/ops/pallas_integrator.py``. The kernel
(``csrc/pulse_integrator.cu``) replaces the Pallas kernel ``_kernel``, in
float32 (K1) and with ``bf16_rhs`` (K6, one more template instance), and
``integrate_pulse_cuda`` replaces its host side (``_pallas_core``): the dt
law and clamp, the per-env coefficients, the descending-n sort, the launch.
The kernel reads and writes env ``perm[t]`` from thread t, so no gather or
unsort pass is needed. The kernel's plain version is
``physics.integrator.integrate_pulse_plain``.

K5, the sharded pulse of the data-parallel path (``_integrate_pulse_pallas_sharded``
and ``_shard_seed``), is the same kernel launched on one rank's shard with
``env_offset``, the shard's first global row (``shard_env_offset``): the
shard sorts its own envs, and its thermal draws are its rows of the
unsharded stream. Sharded launches count in ``PULSE_SHARDED_LAUNCHES``, the
others in ``PULSE_LAUNCHES`` (K1) or ``PULSE_BF16_LAUNCHES`` (K6).

Dispatch is by device: ``physics.integrator.integrate_pulse`` sends CUDA
tensors here, and this wrapper launches the kernel or raises. It never falls
back to the plain version.

The kernel's design (one consumer warp of 32 envs per block, the thermal
sampler on producer warps feeding it through a ring in shared memory) is
described in its source; ``pulse_chain_depth`` gives the dependent depth
of one substep that bounds it, and ``pulse_chain_floor_ms`` that depth
priced at measured op latencies. The wrappers launch through
``ops._build.launch``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..physics.integrator import (
    IntegratorConfig,
    PulseResult,
    check_config,
    check_env_offset,
    clamped_substep_counts,
    noise_draws,
    noise_sigma,
)
from ..physics.llgs import LLGSParams, coefficients
from ..utils.profiling import counter
from ..utils.profiling import span as trace_span
from . import _build
from .philox import seed_key

Tensor = torch.Tensor

# Substeps per slot of the kernel's thermal ring (kChunk in
# csrc/pulse_integrator.cu; half that for per-stage RK4), for tests that
# place n at a chunk's edge.
PULSE_CHUNK = 8
_METHODS = {"euler": 0, "heun": 1, "rk4": 2}


PULSE_LAUNCHES = counter("pulse.launches")  # K1
PULSE_BF16_LAUNCHES = counter("pulse.bf16_launches")  # K6
PULSE_SHARDED_LAUNCHES = counter("pulse.sharded_launches")  # K5 (float32 or bf16_rhs, on a shard)
PROBE_LAUNCHES = counter("probe.launches")  # K2


def shard_env_offset(rank: int, local_batch: int) -> int:
    """Global index of the first env of data shard ``rank`` of
    ``local_batch`` envs: the Philox counter's env word on that shard.

    The counterpart of ``_shard_seed``. The JAX kernel seeds each tile with
    seed + tile id, and tile ids repeat on every shard, so there every shard
    offsets its seed lest all shards draw identical thermal fields. Here the
    counter holds the env's index, which repeats on every shard just as
    well (rows 0..B/W-1). Offsetting the index, not the seed, makes shard r
    draw exactly rows [r B/W, (r+1) B/W) of the unsharded stream: a sharded
    pulse equals the unsharded one bit for bit, thermal included."""
    return rank * local_batch


# Operations of one substep, counted from the kernel (and its plain
# version): each add, multiply, divide, sqrt, log, compare or select counts
# one, so a transcendental's instruction sequence is undercounted and the
# bound computed from these is a lower bound. K6 counts the same ops, its
# conversions (the state's rounding, the increment's widening, div6's) left
# out, and runs most of them as native bf16 instructions, which the card
# issues at twice the float32 rate (``pulse_bf16_ops_per_substep``). rhs:
# +z / general axis, with the thermal adds. A Philox call is 10 rounds of
# two 32x32 multiplies (high and low words), four xors and two key adds;
# its four normals are two Box-Muller pairs of ~40 ops (uniforms, log,
# sqrt, the folded cos/sin).
_RHS_OPS = {True: 46, False: 64}
_NORMALIZE_OPS = 9 + 7  # squares, sqrt, divides; finiteness compares, selects
_FLUSH_OPS = 3  # the subnormal flush: one multiply by 1 with flush-to-zero a component
_NEGATIVE_ZERO_OPS = 3  # +z: the -0 compares of the new state, beside the zero-row test
_PHILOX_CALL_OPS = 10 * 10 + 2 * 40


def pulse_ops_per_substep(config: IntegratorConfig, plus_z: bool) -> int:
    """Operations of one substep of one env (see ``_RHS_OPS``)."""
    r = _RHS_OPS[plus_z]
    if config.method == "euler":
        ops = r + 3 + 3
    elif config.method == "heun":
        ops = 2 * r + 6 + 1 + 6 + 3
    else:
        ops = 4 * r + 12 + 15 + 18 + 3
    ops += _NORMALIZE_OPS + _FLUSH_OPS + 4  # the failed flag's compares
    if plus_z:
        ops += _NEGATIVE_ZERO_OPS
    if config.thermal:
        draws = noise_draws(config)
        ops += draws * _PHILOX_CALL_OPS + (12 if draws == 3 else 3)
    return ops


def pulse_bf16_ops_per_substep(config: IntegratorConfig, plus_z: bool) -> int:
    """The share of ``pulse_ops_per_substep`` that K6 (``bf16_rhs``) runs
    as native bf16 instructions: every stage op, in the right-hand side and
    around it, but RK4's three divisions by 6 and the state's add, which are
    float; 0 without ``bf16_rhs``."""
    if not config.bf16_rhs:
        return 0
    r = _RHS_OPS[plus_z]
    # Euler: dt * f. Heun: the predictor's dt * f and add, half_dt, and
    # half_dt * (f + g). RK4: dt * k, the stages' 0.5 * k and adds, and the
    # weighted sum's two products and three adds a component.
    return {"euler": r + 3, "heun": 2 * r + 6 + 1 + 6, "rk4": 4 * r + 12 + 15 + 15}[config.method]


def pulse_work(n_substeps: Tensor, config: IntegratorConfig, plus_z: bool) -> Tuple[int, int]:
    """(operations, bytes) a pulse call over envs with these substep counts
    must do and move: each env's substeps at ``pulse_ops_per_substep``, and
    each input read once (state, n, dt, five coefficients, sigma when
    thermal, the axis when general, the sort's int64 permutation) and each
    output written once (state, failed). Reads ``n_substeps`` to the host."""
    batch = n_substeps.numel()
    ops = int(n_substeps.to(torch.int64).sum()) * pulse_ops_per_substep(config, plus_z)
    floats_in = 3 + 1 + 5 + int(config.thermal) + (0 if plus_z else 3)
    bytes_moved = batch * (4 * floats_in + 4 + 8 + 3 * 4 + 1)
    return ops, bytes_moved


# The dependent depth of one substep, counted from csrc/llgs_substep.cuh along
# its longest path from the state to the next state, by op class (the
# classes ops.op_chain prices). rhs: the deepest output of the right-hand
# side in adds and multiplies (negations fold into their users in float32
# and lie off the longest path in bf16), +z and general axis; a thermal
# field adds its one add onto H. The stage ops of a substep outside rhs:
# Euler dt * f; Heun dt * f, the predictor's add, f + g and the half-step
# product; RK4 per stage dt * k, 0.5 * k and the stage's add (two ops for
# the last stage), then the weighted sum's last add. A stage op is one op
# of the stage type's class: ``simple`` in float32, ``bf16`` (one native
# bf16 instruction) with bf16_rhs, which adds two conversions, the rounding
# of the state into bf16 and the widening of the increment. Then the
# state's add; RK4's div6 (a multiply and two FMAs, then a select; in bf16
# also its widening and rounding); normalize: the squared norm (a multiply
# and two adds), the select that gives sqrt a finite input, sqrt, the
# compare and the division; the subnormal flush's compare and select. A
# non-finite increment takes the fallback to +z by a branch, which skips
# the division. The thermal sampler runs on producer warps and adds no
# depth.
_RHS_DEPTH = {True: 10, False: 14}


def pulse_chain_depth(
    config: IntegratorConfig, plus_z: bool, fallback: bool = False
) -> Dict[str, int]:
    """The kernel's dependent depth of one substep by op class: ``simple``
    (float32 add, multiply, compare, FMA, conversion), ``bf16`` (a native
    bf16 add, subtract or multiply: K6's stage ops), ``select``, ``div``,
    ``sqrt``, ``log`` and ``cos`` (the last two 0: the sampler is off the
    chain). ``fallback``: the substep's increment is not finite, so the
    normalization falls back to +z and does not divide (``div`` 0)."""
    check_config(config)
    r = _RHS_DEPTH[plus_z] + int(config.thermal)
    stage_ops = {"euler": r + 1, "heun": 2 * r + 4, "rk4": 4 * r + 10}[config.method]
    bf16 = stage_ops if config.bf16_rhs else 0
    simple = 2 if config.bf16_rhs else stage_ops  # the state's rounding, the increment's widening
    select = 2  # normalize's, before sqrt; the subnormal flush's
    if config.method == "rk4":
        simple += 3 + (2 if config.bf16_rhs else 0)  # div6, widened and rounded in bf16
        select += 1
    simple += 1 + 3 + 1 + 1  # the state's add; the squared norm; the compare; the flush's
    return {"simple": simple, "bf16": bf16, "select": select, "div": int(not fallback),
            "sqrt": 1, "log": 0, "cos": 0}


def pulse_chain_floor_ms(
    n_substeps: Tensor,
    config: IntegratorConfig,
    plus_z: bool,
    latency_ns: Dict[str, float],
    fallback: bool = False,
) -> float:
    """The least time of a pulse call at the chain's latency: the longest
    env's substeps times ``pulse_chain_depth`` (on the fallback path when
    ``fallback``) priced at ``latency_ns`` (ns per dependent op by class,
    ``ops.op_chain.measure_op_costs``'s ``latency_ns``; ``bf16`` is needed
    only with ``bf16_rhs``). The fallback path
    is the shorter, so its floor holds whichever path the data takes. Reads
    ``n_substeps`` to the host."""
    n_max = int(n_substeps.max()) if n_substeps.numel() else 0
    depth = pulse_chain_depth(config, plus_z, fallback)
    return n_max * sum(d * latency_ns[c] for c, d in depth.items() if d) * 1e-6


def _axis_on_host(easy_axis) -> torch.Tensor:
    return torch.as_tensor(easy_axis).detach().to("cpu", torch.float64).reshape(-1, 3)


def is_plus_z(easy_axis) -> bool:
    """True when every easy axis is exactly +z (reads the axis to the host)."""
    e = _axis_on_host(easy_axis)
    return bool(((e[:, 0].abs() < 1e-12) & (e[:, 1].abs() < 1e-12) & (e[:, 2] > 0)).all())


def cuda_supported(params: LLGSParams, config: IntegratorConfig, dtype) -> bool:
    """Whether the kernel covers this configuration: float32, a known method
    (with or without bf16 stage arithmetic), and a finite nonzero easy axis
    (read to the host, so call it once at build time, not per step)."""
    if config.method not in _METHODS:
        return False
    if dtype != torch.float32:
        return False
    e = _axis_on_host(params.easy_axis)
    return bool(torch.isfinite(e).all() and (torch.linalg.vector_norm(e, dim=-1) > 1e-12).all())


_PROBE_PASSED = False


def cuda_kernel_available() -> bool:
    """False without a CUDA device. Otherwise builds the kernel library
    (once), launches the probe kernel once, checks its result and caches
    True; raises when the build or the probe fails. Thread-safe: threads
    that call it together build and probe once (under
    ``_build.BUILD_LOCK``)."""
    global _PROBE_PASSED
    if not torch.cuda.is_available():
        return False
    if _PROBE_PASSED:
        return True
    with _build.BUILD_LOCK:
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
    """``x + 1`` by the probe kernel, on a nonempty contiguous float32 CUDA
    tensor."""
    if not (isinstance(x, Tensor) and x.is_cuda):
        raise ValueError("probe_add_one takes a CUDA tensor")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("probe_add_one takes a nonempty contiguous float32 tensor")
    y = torch.empty_like(x)
    rc = _build.launch(_build.kernel_fn("spintorque_probe_add_one"), x.device, x.data_ptr(),
                       y.data_ptr(), x.numel())
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {rc}")
    PROBE_LAUNCHES.add()
    return y


def check_div6(device="cuda") -> Tuple[int, int]:
    """Runs the exhaustive check of the kernel's ``div6`` against the IEEE
    quotient ``x / 6.0f`` over all 2^32 float32 inputs on the card, and
    returns (inputs that differ in value, NaN inputs whose NaN results
    differ only in payload). Synchronizes."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    rc = _build.launch(_build.kernel_fn("spintorque_check_div6"), counts.device,
                       counts.data_ptr())
    if rc != 0:
        raise RuntimeError(f"div6 check kernel launch failed: cudaError {rc}")
    bad, payload = counts.tolist()
    return bad, payload


# The ops of spintorque_check_bf16_ops, in its order (Bf16CheckOp in
# csrc/pulse_integrator.cu): binary over every ordered pair of bf16 values,
# unary ("neg", "half" = 0.5 x, "two" = 2 x) over every bf16 value. K6
# computes every one of them natively. Last the check's control, "fma"
# (x * y + x fused, rounded once where PyTorch rounds twice), over every
# pair: K6 never uses it, and the check must find it different.
BF16_BINARY_OPS = ("add", "sub", "mul")
BF16_OPS = BF16_BINARY_OPS + ("neg", "half", "two")
BF16_CONTROL = "fma"


def check_bf16_ops(device="cuda") -> Dict[str, Tuple[int, Optional[Tuple[int, ...]]]]:
    """Runs the exhaustive check of K6's native bf16 ops against PyTorch's
    bf16 ops (the float op rounded once to bf16) on the card: all 2^32
    ordered pairs of bf16 bit patterns for add, sub, mul and the control,
    all 2^16 for neg and the products by 0.5 and by 2; two NaNs count as
    equal, any other difference in bits (the sign of zero too) as a
    mismatch. Returns per op of ``BF16_OPS`` and for ``BF16_CONTROL`` (its
    mismatches, the bit patterns of its first mismatching input: (a, b) for
    a binary op, (a,) for a unary one, None without a mismatch).
    Synchronizes."""
    ops = BF16_OPS + (BF16_CONTROL,)
    counts = torch.zeros(len(ops), dtype=torch.int64, device=device)
    first = torch.full((len(ops),), -1, dtype=torch.int64, device=device)  # all ones
    rc = _build.launch(_build.kernel_fn("spintorque_check_bf16_ops"), counts.device,
                       counts.data_ptr(), first.data_ptr())
    if rc != 0:
        raise RuntimeError(f"bf16 op check kernel launch failed: cudaError {rc}")
    out = {}
    for op, bad, index in zip(ops, counts.tolist(), first.tolist()):
        pair = None
        if bad:
            index &= 2**64 - 1
            binary = op in BF16_BINARY_OPS or op == BF16_CONTROL
            pair = (index >> 16, index & 0xFFFF) if binary else (index,)
        out[op] = (bad, pair)
    return out


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


def check_no_grad(m0, span, current) -> None:
    """Raise when any of m0's components, span or current requires a
    gradient: the kernel has no backward, and a launch would drop the
    graph without a word."""
    named = (("m0", m0[0]), ("m0", m0[1]), ("m0", m0[2]), ("span", span), ("current", current))
    wants = sorted({name for name, t in named if isinstance(t, Tensor) and t.requires_grad})
    if wants:
        raise RuntimeError(
            f"the CUDA pulse kernel takes no gradient ({', '.join(wants)} requires grad); "
            "differentiate through the plain loop instead: "
            "physics.integrator.integrate_pulse_plain or integrate_pulse_trajectory"
        )


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
    *,
    env_offset: int = 0,
    sharded: Optional[bool] = None,
) -> PulseResult:
    """``physics.integrator.integrate_pulse`` by the CUDA kernel.

    Takes contiguous float32 (B,) CUDA tensors for m0's components, span and
    current; params fields on the same device, 0-dim or (B,) ((3,) or (B, 3)
    for the easy axis). Raises on anything else, on an unknown method and
    on an ``env_offset`` whose global indices pass 2^32. Launches K6 when
    ``config.bf16_rhs``, else K1, on the current stream and does not
    synchronize; it reads nothing back from the device unless
    ``params.plus_z`` is None. ``env_offset`` is the global index of env 0
    in the thermal stream; a ``sharded`` launch (default: a nonzero offset)
    is K5 and counts in ``PULSE_SHARDED_LAUNCHES``.

    The kernel takes no gradient: inputs that require one raise (before
    any build or launch), and never fall back to the plain loop, which
    does differentiate (``physics.integrator.integrate_pulse_plain`` and
    ``integrate_pulse_trajectory``).
    """
    check_no_grad(m0, span, current)
    mx0 = m0[0]
    if not isinstance(mx0, Tensor) or mx0.device.type != "cuda":
        raise ValueError("integrate_pulse_cuda takes CUDA tensors")
    _check_tensor("span", span, mx0.device, mx0.shape)
    check_config(config)
    with trace_span("cuda_integrator.dt_law"):
        dt, n = clamped_substep_counts(span, config)
    return launch_pulse(m0, dt, n, current, params, config, seed, temperature,
                        env_offset=env_offset, sharded=sharded)


def launch_pulse(
    m0: Tuple[Tensor, Tensor, Tensor],
    dt: Tensor,
    n: Tensor,
    current: Tensor,
    params: LLGSParams,
    config: IntegratorConfig,
    seed: Optional[int] = None,
    temperature=300.0,
    *,
    env_offset: int = 0,
    sharded: Optional[bool] = None,
) -> PulseResult:
    """The pulse kernel's launch for given per-env substeps: env b runs
    ``n[b]`` (int32) substeps of ``dt[b]`` (``integrate_pulse_cuda`` takes
    both from the dt law; a test may pass any counts, 0 included). The other
    arguments and the checks are ``integrate_pulse_cuda``'s."""
    check_no_grad(m0, dt, current)
    check_config(config)
    mx0, my0, mz0 = m0
    if not isinstance(mx0, Tensor) or mx0.device.type != "cuda":
        raise ValueError("integrate_pulse_cuda takes CUDA tensors")
    device = mx0.device
    batch = mx0.shape[0] if mx0.dim() == 1 else -1
    for name, t in (("mx0", mx0), ("my0", my0), ("mz0", mz0), ("dt", dt), ("current", current)):
        _check_tensor(name, t, device, (batch,))
    _check_tensor("n", n, device, (batch,), torch.int32)
    if config.thermal and seed is None:
        raise ValueError("integrate_pulse: thermal=True requires a seed")
    check_env_offset(env_offset, batch)
    if sharded is None:
        sharded = env_offset != 0
    with trace_span("cuda_integrator.coefficients"):
        plus_z = params.plus_z if params.plus_z is not None else is_plus_z(params.easy_axis)
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

    with trace_span("cuda_integrator.sort"):
        # Descending n: a warp then holds envs of similar length and runs to
        # its own longest. Thread t integrates env perm[t] in place of a
        # gather before the kernel and an unsort after it.
        perm = torch.argsort(-n, stable=True)

    with trace_span("cuda_integrator.launch"):
        mx = torch.empty_like(mx0)
        my = torch.empty_like(mx0)
        mz = torch.empty_like(mx0)
        failed = torch.empty((batch,), dtype=torch.bool, device=device)
        seed_lo, seed_hi = seed_key(seed if config.thermal else 0)

        def ptr(name):
            t = per_env.get(name)
            return None if t is None else t.data_ptr()

        rc = _build.launch(
            _build.kernel_fn("spintorque_pulse_integrate"), device,
            mx0.data_ptr(), my0.data_ptr(), mz0.data_ptr(), n.data_ptr(), dt.data_ptr(),
            ptr("sigma"), ptr("h_k"), ptr("ms"), ptr("neg_gamma_eff"), ptr("alpha"), ptr("stt"),
            ptr("ex"), ptr("ey"), ptr("ez"), perm.data_ptr(),
            mx.data_ptr(), my.data_ptr(), mz.data_ptr(), failed.data_ptr(),
            batch, _METHODS[config.method], int(config.thermal),
            int(noise_draws(config) == 3), int(plus_z), int(config.bf16_rhs), seed_lo, seed_hi,
            env_offset,
        )
    if rc != 0:
        raise RuntimeError(f"pulse kernel launch failed: cudaError {rc}")
    if sharded:
        PULSE_SHARDED_LAUNCHES.add()
    else:
        (PULSE_BF16_LAUNCHES if config.bf16_rhs else PULSE_LAUNCHES).add()
    return PulseResult(m=(mx, my, mz), n_substeps=n, dt=dt, failed=failed)
