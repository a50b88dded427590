"""Adaptive-step LLGS integration: embedded Dormand-Prince RK5(4) for the
nonstiff names, 3-stage Radau IIA (order 5) for the stiff names, and the
order-2 implicit midpoint.

PyTorch counterpart of ``spintorque_tpu/physics/adaptive.py``. Each method
advances a whole batch in lockstep: every env carries its own (t, dt) and
integrates until its own t_end, masked once finished. Plain torch on any
device and dtype (no kernel: the JAX package runs these through XLA, not
Pallas); on the card every op is its own launch.

The loop. The JAX package runs one ``lax.while_loop`` whose condition,
``(i < max_steps) & any(t < span)``, is a host read per iteration once the
loop runs eagerly. Here the condition is read every ``CHECK_EVERY``
iterations (the last chunk capped at ``max_steps``). A finished env is a
masked no-op in every body (its h is 0, its state and t are selected back,
its dt is kept), so the extra iterations of a chunk change no bit: any
chunk gives the bits of a read every iteration.

The batch. Inputs of any batch shape are flattened to one batch dimension
at entry and restored at exit, so the Radau path's batched 9x9 Newton
solve takes scalar or N-d inputs too (the JAX package's assumes a 1-D
batch).

Subnormals. XLA flushes float subnormals to zeros of their sign; torch
keeps them. The carried state is flushed (``integrator.flush_subnormal``)
on entry and after every accepted update, so a pole state with subnormal
transverse parts stays at its pole and a state decaying through the
subnormal range reaches it exactly, sign bits included, as in the JAX
package (``tests/test_torch_subnormal_parity.py``).

Jacobians are exact: the chain rule of the renormalized RHS written out
as batched 3x3 matrices (``_rhs_and_jacobian``), where the JAX package
takes ``jax.linearize`` (the tests hold it to forward-mode autodiff); a
few dozen ops, where ``torch.func`` forward mode took ~10x the time a
Newton iteration. Newton's quadratic convergence sets the implicit step
sizes. Radau keeps the JAX package's fixed 6 full-Newton iterations.

Also: energy and torque along a trajectory, and the relaxation-based
stable-state search.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..constants import GAMMA, MU0
from .integrator import flush_subnormal
from .llgs import LLGSParams, _rdiv, dmdt, energy_density, normalize_with_fallback

Tensor = torch.Tensor


class _RHS(NamedTuple):
    """Loop invariants of ``llgs_solver_rhs`` and of its Jacobian. The
    per-env fields are 0-dim (shared) or carry the batch dim first: the
    scalars (B,), ``e`` (B, 3), ``j_h`` (B, 3, 3)."""

    ms: Tensor
    alpha: Tensor
    ex: Tensor
    ey: Tensor
    ez: Tensor
    h_k: Tensor
    ex_coeff: Tensor  # the placeholder exchange term's coefficient
    coeff: Tensor  # Slonczewski beta J, 0 where |J| <= 1e-12
    e: Tensor  # the unit easy axis
    j_h: Tensor  # d H / d m: h_k e e^T - Ms diag(N) + c_ex I
    demag: Tuple[float, float, float]
    h_applied: Tuple[float, float, float]
    consts: dict  # constant tensors of the Jacobian, on the device


# Per-env fields of _RHS and the rank of one env's value.
_PER_ENV = dict(ms=0, alpha=0, ex=0, ey=0, ez=0, h_k=0, ex_coeff=0, coeff=0, e=1, j_h=2)
# skew(a)[i, j] = sign[i, j] * a[idx[i, j]], so that skew(a) @ b = a x b.
_SKEW_IDX = ((0, 2, 1), (2, 0, 0), (1, 0, 0))
_SKEW_SIGN = ((0.0, -1.0, 1.0), (1.0, 0.0, -1.0), (-1.0, 1.0, 0.0))


def _rhs_invariants(current, params: LLGSParams, demag_factors=(0.0, 0.0, 1.0),
                    exchange_constant=20e-12, h_applied=(0.0, 0.0, 0.0)) -> _RHS:
    ms = params.saturation_magnetization
    dtype, device = ms.dtype, ms.device
    e = params.easy_axis
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    norm = torch.sqrt(ex * ex + ey * ey + ez * ez)
    ex, ey, ez = ex / norm, ey / norm, ez / norm
    h_k = (2.0 * params.uniaxial_anisotropy) / (MU0 * ms)
    ex_coeff = _rdiv(2.0 * exchange_constant, MU0 * ms) * 0.1  # placeholder
    current = torch.as_tensor(current, dtype=dtype, device=device)
    beta = params.polarization * GAMMA / (2.0 * ms * params.volume)
    coeff = torch.where(torch.abs(current) > 1e-12, beta * current, 0.0)

    def host(x):
        return torch.tensor(x, dtype=dtype).to(device)

    eye = torch.eye(3, dtype=dtype, device=device)
    demag = torch.diag(host(demag_factors))
    e_vec = torch.stack((ex, ey, ez), dim=-1)
    j_h = (h_k[..., None, None] * e_vec[..., :, None] * e_vec[..., None, :]
           - ms[..., None, None] * demag + ex_coeff[..., None, None] * eye)
    consts = dict(
        eye=eye, demag=demag, h_applied=host(h_applied),
        j_u=host(((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 0.0))),  # d(m x z)/dm
        skew_idx=torch.tensor(_SKEW_IDX).to(device), skew_sign=host(_SKEW_SIGN),
    )
    return _RHS(ms, params.damping, ex, ey, ez, h_k, ex_coeff, coeff, e_vec, j_h,
                tuple(demag_factors), tuple(h_applied), consts)


def _tile(c: _RHS, k: int) -> _RHS:
    """The invariants of a batch stacked ``k`` times along its batch dim."""
    return c._replace(**{name: torch.cat([getattr(c, name)] * k)
                         for name, rank in _PER_ENV.items() if getattr(c, name).ndim > rank})


def _rhs_from(mx, my, mz, c: _RHS):
    """``llgs_solver_rhs`` from its invariants, in the JAX package's op order."""
    m_dot_e = mx * c.ex + my * c.ey + mz * c.ez
    nx_, ny_, nz_ = c.demag
    ha = c.h_applied
    hx = ha[0] + c.h_k * m_dot_e * c.ex - c.ms * nx_ * mx + c.ex_coeff * mx
    hy = ha[1] + c.h_k * m_dot_e * c.ey - c.ms * ny_ * my + c.ex_coeff * my
    hz = ha[2] + c.h_k * m_dot_e * c.ez - c.ms * nz_ * mz + c.ex_coeff * mz

    # precession + explicit Gilbert damping
    px = my * hz - mz * hy
    py = mz * hx - mx * hz
    pz = mx * hy - my * hx
    gx, gy, gz = -GAMMA * px, -GAMMA * py, -GAMMA * pz
    dx = gx + c.alpha * (my * gz - mz * gy)
    dy = gy + c.alpha * (mz * gx - mx * gz)
    dz = gz + c.alpha * (mx * gy - my * gx)

    # Slonczewski torque, p = z
    coeff = c.coeff
    ux, uy = my, -mx  # m x z
    tx = coeff * (-(mz * uy)) + 0.1 * coeff * ux
    ty = coeff * (mz * ux) + 0.1 * coeff * uy
    tz = coeff * (mx * uy - my * ux)
    return dx + tx, dy + ty, dz + tz


def llgs_solver_rhs(mx, my, mz, current, params: LLGSParams,
                    demag_factors=(0.0, 0.0, 1.0), exchange_constant=20e-12,
                    h_applied=(0.0, 0.0, 0.0)):
    """The adaptive solver's RHS, which differs from the fixed-step one:
    explicit Gilbert damping dm += alpha m x dm (no 1/(1+alpha^2)
    prefactor), general demag factors, a placeholder exchange field
    parallel to m (torque-free), and Slonczewski beta = P gamma / (2 Ms V)
    with a 0.1 beta field-like term."""
    return _rhs_from(mx, my, mz, _rhs_invariants(current, params, demag_factors,
                                                 exchange_constant, h_applied))


def _renormalized_rhs(mx, my, mz, c: _RHS):
    """The RHS at m / |m| ([0, 0, 1] where |m| <= 1e-12): every evaluation
    renormalizes its stage state, which the explicit pair needs for
    stability; smooth away from 0, so forward mode differentiates it."""
    n = torch.sqrt(mx * mx + my * my + mz * mz)
    ok = n > 1e-12
    safe = torch.where(ok, n, 1.0)
    mx = torch.where(ok, mx / safe, 0.0)
    my = torch.where(ok, my / safe, 0.0)
    mz = torch.where(ok, mz / safe, 1.0)
    return _rhs_from(mx, my, mz, c)


def _fvec(y: Tensor, c: _RHS) -> Tensor:
    """(..., 3) -> (..., 3)."""
    return torch.stack(_renormalized_rhs(y[..., 0], y[..., 1], y[..., 2], c), dim=-1)


def _rhs_and_jacobian(y: Tensor, c: _RHS) -> Tuple[Tensor, Tensor]:
    """(F, J) at y (B, 3): F = f(y), the renormalized RHS, and its exact
    Jacobian J[b, p, q] = d f_p / d m_q, by the chain rule written out:
    f = R(n), n = m / |m|, J = J_R(n) (I - n n^T) / |m| (0 where |m| <=
    1e-12, where f is constant). With h the field, g = -gamma n x h, u =
    n x z and [a] the matrix of a x .: J_(n x h) = [n] J_h - [h], J_g =
    -gamma J_(n x h), the damped term J_g + alpha ([n] J_g - [g]), and the
    torque beta J ([n] J_u - [u] + 0.1 J_u) with J_u = d(n x z)/dn.
    ``tests/test_torch_adaptive.py`` holds it to forward-mode autodiff."""
    k = c.consts
    mx, my, mz = y.unbind(-1)
    norm = torch.sqrt(mx * mx + my * my + mz * mz)
    ok = norm > 1e-12
    safe = torch.where(ok, norm, 1.0)
    nx = torch.where(ok, mx / safe, 0.0)
    ny = torch.where(ok, my / safe, 0.0)
    nz = torch.where(ok, mz / safe, 1.0)
    F = torch.stack(_rhs_from(nx, ny, nz, c), dim=-1)
    n = torch.stack((nx, ny, nz), dim=-1)

    def v(x):  # a per-env scalar against (B, 3)
        return x[..., None] if x.ndim else x

    def s(x):  # against (B, 3, 3)
        return x[..., None, None] if x.ndim else x

    def skew(a):
        return a[..., k["skew_idx"]] * k["skew_sign"]

    j_n = (k["eye"] - n[..., :, None] * n[..., None, :]) / safe[..., None, None]
    j_n = torch.where(ok[..., None, None], j_n, 0.0)
    h = (k["h_applied"] + v(c.h_k * (n * c.e).sum(-1)) * c.e - v(c.ms) * (n @ k["demag"])
         + v(c.ex_coeff) * n)
    skew_n = skew(n)
    j_g = -GAMMA * (skew_n @ c.j_h - skew(h))
    g = -GAMMA * torch.linalg.cross(n, h, dim=-1)
    j_r = j_g + s(c.alpha) * (skew_n @ j_g - skew(g))
    j_u = k["j_u"]
    u = n @ j_u.T  # n x z
    j_r = j_r + s(c.coeff) * (skew_n @ j_u - skew(u) + 0.1 * j_u)
    return F, j_r @ j_n


# Dormand-Prince RK5(4) tableau.
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


class AdaptiveResult(NamedTuple):
    m: Tuple[Tensor, Tensor, Tensor]
    n_steps: Tensor  # accepted steps, int32, the batch's shape
    n_rejected: Tensor
    success: Tensor  # reached t_end within max_steps
    iterations: int = 0  # loop iterations run (whole chunks)
    host_reads: int = 0  # termination tests read back to the host


# The explicit names run the embedded Dormand-Prince RK5(4) pair; the scipy
# stiff names the 3-stage Radau IIA (order 5, L-stable); 'midpoint' the
# order-2 A-stable implicit midpoint with step-doubling control.
_EXPLICIT_METHODS = ("rk45", "dop853", "dopri5")
_RADAU_METHODS = ("radau", "bdf", "lsoda")
_MIDPOINT_METHODS = ("midpoint",)
_IMPLICIT_METHODS = _RADAU_METHODS + _MIDPOINT_METHODS

# Loop iterations between two reads of the termination test.
CHECK_EVERY = 8


def _flatten_params(params: LLGSParams, shape) -> LLGSParams:
    """Batch-shaped fields of ``params`` flattened to one batch dim; 0-dim
    fields and a (3,) easy axis stay."""
    def flat(x, tail):
        if x.ndim == len(tail):
            return x
        return torch.broadcast_to(x, tuple(shape) + tail).reshape((-1,) + tail)

    return LLGSParams(
        saturation_magnetization=flat(params.saturation_magnetization, ()),
        damping=flat(params.damping, ()),
        uniaxial_anisotropy=flat(params.uniaxial_anisotropy, ()),
        volume=flat(params.volume, ()),
        polarization=flat(params.polarization, ()),
        easy_axis=flat(params.easy_axis, (3,)),
        plus_z=params.plus_z,
    )


def _drive(body, carry, span, max_steps: int):
    """Run ``body`` until no env has t < span or ``max_steps`` iterations
    have run, testing termination every ``CHECK_EVERY`` iterations (the
    carry's first entry is t). Returns (carry, iterations, host reads)."""
    i = reads = 0
    while i < max_steps:
        reads += 1
        if not bool((carry[0] < span).any()):
            break
        for _ in range(min(CHECK_EVERY, max_steps - i)):
            carry = body(carry)
            i += 1
    return carry, i, reads


def integrate_adaptive(
    m0: Tuple[Tensor, Tensor, Tensor],
    span,
    current,
    params: LLGSParams,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps: int = 100_000,
    dt_init: float = 1e-13,
    dt_min: float = 1e-16,
    dt_max: float = 1e-11,
    method: str = "rk45",
) -> AdaptiveResult:
    """Batched adaptive integration over one square pulse (deterministic).

    ``m0``: components of one batch shape; ``span`` and ``current``
    broadcast to it; ``params`` fields 0-dim or of the batch shape. Runs in
    the dtype and on the device of ``m0``. ``method``: 'rk45'/'dop853'/
    'dopri5' - embedded explicit RK5(4) pair; 'radau'/'bdf'/'lsoda' -
    3-stage Radau IIA, order 5, L-stable, full Newton; 'midpoint' - order-2
    A-stable implicit midpoint with step-doubling error control. The loop
    reads its termination test every ``CHECK_EVERY`` iterations (the
    module docstring: that changes no bit)."""
    meth = method.lower()
    if meth not in _EXPLICIT_METHODS + _IMPLICIT_METHODS:
        raise ValueError(
            f"integrate_adaptive: unknown method {method!r}; choose one of "
            f"{_EXPLICIT_METHODS + _IMPLICIT_METHODS}"
        )
    mx0 = torch.as_tensor(m0[0])
    dtype, device, shape = mx0.dtype, mx0.device, mx0.shape

    def flat(x):
        x = torch.as_tensor(x, dtype=dtype, device=device)
        return torch.broadcast_to(x, shape).reshape(-1)

    # XLA flushes float subnormals to zero, so the JAX package's solve
    # holds a pole state with subnormal transverse components at the pole.
    y0 = flush_subnormal(torch.stack([flat(c) for c in m0])).unbind(0)
    span, current = flat(span), flat(current)
    params = _flatten_params(params.to(device=device, dtype=dtype), shape)
    c = _rhs_invariants(current, params)
    tiny = 1e-300 if dtype == torch.float64 else 1e-30
    settings = (rtol, atol, dt_min, dt_max, tiny)
    if meth in _RADAU_METHODS:
        body = _radau5_body(c, span, settings)
        y0 = torch.stack(y0, dim=-1)
    elif meth in _MIDPOINT_METHODS:
        body = _implicit_midpoint_body(c, span, settings)
    else:
        body = _rk45_body(c, span, settings)

    n = span.shape[0]
    zeros_i = torch.zeros(n, dtype=torch.int32, device=device)
    carry = (torch.zeros(n, dtype=dtype, device=device),
             torch.full((n,), dt_init, dtype=dtype, device=device), y0, zeros_i, zeros_i)
    (t, _, y, nacc, nrej), iterations, reads = _drive(body, carry, span, max_steps)
    m = y.unbind(-1) if isinstance(y, Tensor) else y
    return AdaptiveResult(
        m=tuple(x.reshape(shape) for x in m), n_steps=nacc.reshape(shape),
        n_rejected=nrej.reshape(shape), success=(t >= span).reshape(shape),
        iterations=iterations, host_reads=reads,
    )


def _controller(ratio, dt, dt_min, dt_max, order_exp, max_factor):
    """(accept, new dt): a non-finite ratio (a blown-up env) reads as a
    max-rate rejection, not a NaN that stalls; dt *= 0.9 ratio^-order_exp,
    the factor clipped to [0.2, max_factor]."""
    ratio = torch.where(torch.isfinite(ratio), ratio, 1e6)
    accept = (ratio <= 1.0) | (dt <= dt_min)
    factor = torch.clamp(0.9 * torch.pow(torch.clamp_min(ratio, 1e-10), -order_exp),
                         0.2, max_factor)
    return accept, torch.clamp(dt * factor, dt_min, dt_max)


def _rk45_body(c: _RHS, span, settings):
    rtol, atol, dt_min, dt_max, tiny = settings

    def f(mx, my, mz):
        return _renormalized_rhs(mx, my, mz, c)

    def body(carry):
        t, dt, (mx, my, mz), nacc, nrej = carry
        active = t < span
        dt_eff = torch.minimum(dt, span - t)
        dt_eff = torch.where(active, dt_eff, 0.0)

        ks = []
        for s in range(7):
            ax, ay, az = mx, my, mz
            for j, a in enumerate(_A[s]):
                ax = ax + dt_eff * a * ks[j][0]
                ay = ay + dt_eff * a * ks[j][1]
                az = az + dt_eff * a * ks[j][2]
            ks.append(f(ax, ay, az))

        def comb(coeffs, k):
            out = torch.zeros_like(mx)
            for j, b in enumerate(coeffs):
                if b != 0.0:
                    out = out + b * ks[j][k]
            return out

        m = (mx, my, mz)
        m5 = tuple(m[k] + dt_eff * comb(_B5, k) for k in range(3))
        m4 = tuple(m[k] + dt_eff * comb(_B4, k) for k in range(3))
        err = torch.sqrt(sum((m5[k] - m4[k]) ** 2 for k in range(3)) / 3.0)
        scale = atol + rtol * torch.sqrt(sum(m5[k] ** 2 for k in range(3)))
        ratio = err / torch.clamp_min(scale, tiny)
        accept, new_dt = _controller(ratio, dt, dt_min, dt_max, 0.2, 5.0)

        do = active & accept
        nx, ny, nz = flush_subnormal(torch.stack(normalize_with_fallback(*m5))).unbind(0)
        mx = torch.where(do, nx, mx)
        my = torch.where(do, ny, my)
        mz = torch.where(do, nz, mz)
        t = torch.where(do, t + dt_eff, t)
        nacc = nacc + do.to(torch.int32)
        nrej = nrej + (active & ~accept).to(torch.int32)
        dt = torch.where(active, new_dt, dt)
        return t, dt, (mx, my, mz), nacc, nrej

    return body


def _solve3(A, bx, by, bz, tiny):
    """Batched 3x3 linear solve by Cramer's rule, elementwise over the
    batch; A is (B, 3, 3)."""
    (a, b, c), (d, e, f), (g, h, i) = (A[:, r].unbind(-1) for r in range(3))
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    det = torch.where(torch.abs(det) > tiny, det, 1.0)
    det_x = bx * (e * i - f * h) - b * (by * i - f * bz) + c * (by * h - e * bz)
    det_y = a * (by * i - f * bz) - bx * (d * i - f * g) + c * (d * bz - by * g)
    det_z = a * (e * bz - by * h) - b * (d * bz - by * g) + bx * (d * h - e * g)
    return det_x / det, det_y / det, det_z / det


_NEWTON_ITERS = 6  # full Newton from an Euler predictor: quadratic, 6 ample


def _implicit_midpoint_body(c: _RHS, span, settings):
    """The implicit midpoint rule y = m + dt f((m + y) / 2), A-stable, so
    its step is limited by accuracy only: full Newton on each env's 3-dim
    system (the exact Jacobian at the midpoint, a 3x3 Cramer solve), error
    by step doubling (Richardson, order 2: |y1 - y2| / 3). Accepted steps
    keep the two half steps' solution."""
    rtol, atol, dt_min, dt_max, tiny = settings
    eye = c.consts["eye"]
    n = span.shape[0]
    c2 = _tile(c, 2)

    def implicit_step(mx, my, mz, dt, c):
        fx, fy, fz = _renormalized_rhs(mx, my, mz, c)
        y = (mx + dt * fx, my + dt * fy, mz + dt * fz)  # Euler predictor
        for _ in range(_NEWTON_ITERS):
            yx, yy, yz = y
            mid = torch.stack((0.5 * (mx + yx), 0.5 * (my + yy), 0.5 * (mz + yz)), dim=-1)
            g, J = _rhs_and_jacobian(mid, c)
            gx, gy, gz = g.unbind(-1)
            res = (yx - mx - dt * gx, yy - my - dt * gy, yz - mz - dt * gz)
            # A = I - (dt/2) J: d(mid)/dy = 1/2.
            A = eye - (0.5 * dt)[:, None, None] * J
            dx, dy, dz = _solve3(A, *res, tiny)
            y = (yx - dx, yy - dy, yz - dz)
        return y

    def body(carry):
        t, dt, (mx, my, mz), nacc, nrej = carry
        active = t < span
        dt_eff = torch.where(active, torch.minimum(dt, span - t), 0.0)

        # One full step and the first of two half steps, as one batch of 2 N.
        both = implicit_step(*(torch.cat((x, x)) for x in (mx, my, mz)),
                             torch.cat((dt_eff, 0.5 * dt_eff)), c2)
        y1 = tuple(x[:n] for x in both)
        y2 = implicit_step(*(x[n:] for x in both), 0.5 * dt_eff, c)

        err = torch.sqrt(sum((y1[k] - y2[k]) ** 2 for k in range(3)) / 3.0) / 3.0
        scale = atol + rtol * torch.sqrt(sum(y2[k] ** 2 for k in range(3)))
        ratio = err / torch.clamp_min(scale, tiny)
        accept, new_dt = _controller(ratio, dt, dt_min, dt_max, 1.0 / 3.0, 5.0)

        do = active & accept
        nx, ny, nz = flush_subnormal(torch.stack(normalize_with_fallback(*y2))).unbind(0)
        mx = torch.where(do, nx, mx)
        my = torch.where(do, ny, my)
        mz = torch.where(do, nz, mz)
        t = torch.where(do, t + dt_eff, t)
        nacc = nacc + do.to(torch.int32)
        nrej = nrej + (active & ~accept).to(torch.int32)
        dt = torch.where(active, new_dt, dt)
        return t, dt, (mx, my, mz), nacc, nrej

    return body


# --- 3-stage Radau IIA (order 5, L-stable) ---------------------------------
# Butcher data (Hairer & Wanner II, the tableau behind scipy's 'Radau').
_S6 = 6.0 ** 0.5
_RADAU_C = ((4.0 - _S6) / 10.0, (4.0 + _S6) / 10.0, 1.0)
_RADAU_A = (
    ((88.0 - 7.0 * _S6) / 360.0, (296.0 - 169.0 * _S6) / 1800.0, (-2.0 + 3.0 * _S6) / 225.0),
    ((296.0 + 169.0 * _S6) / 1800.0, (88.0 + 7.0 * _S6) / 360.0, (-2.0 - 3.0 * _S6) / 225.0),
    ((16.0 - _S6) / 36.0, (16.0 + _S6) / 36.0, 1.0 / 9.0),
)
# Embedded order-3 error weights and the real eigenvalue of A^-1, as in
# scipy's Radau error estimate err = (MU/h I - J)^-1 (f0 + (E.Z)/h).
_RADAU_E = ((-13.0 - 7.0 * _S6) / 3.0, (-13.0 + 7.0 * _S6) / 3.0, -1.0 / 3.0)
_RADAU_MU = 3.0 + 3.0 ** (2.0 / 3.0) - 3.0 ** (1.0 / 3.0)

_RADAU_NEWTON_ITERS = 6  # full Newton from an Euler predictor


def _radau5_body(c: _RHS, span, settings):
    """The order-5 stiff path, over y (N, 3) and stage increments Z (N, 3
    stages, 3):
      * full Newton on each env's 9-dim stage system: every iteration takes
        the exact Jacobian at each stage value; the (N, 9, 9) Newton matrix
        I9 - h (A (x) J_stage) is solved by ``torch.linalg.solve`` (a
        library LU, as the JAX package's ``jnp.linalg.solve``);
      * acceptance combines scipy's smoothed embedded order-3 estimate
        err = (MU/h I - J)^-1 (f0 + (E.Z)/h) (a 3x3 Cramer solve with the
        step-start Jacobian) with the final Newton residual, so a Newton
        that did not converge rejects;
      * dt *= 0.9 ratio^(-1/4) (order-3 estimator), the factor clipped to
        [0.2, 8]. Accepted steps take the stiffly accurate third stage.
    The three stages are evaluated as one batch of 3 N, stage-major
    (``cs`` holds the invariants tiled to it)."""
    rtol, atol, dt_min, dt_max, tiny = settings
    n = span.shape[0]
    dtype, device = span.dtype, span.device
    A3 = torch.tensor(_RADAU_A, dtype=dtype, device=device)
    E3 = torch.tensor(_RADAU_E, dtype=dtype, device=device)
    C3 = torch.tensor(_RADAU_C, dtype=dtype, device=device)
    eye9 = torch.eye(9, dtype=dtype, device=device)
    cs = _tile(c, 3)

    def stages(y, Z):
        """The three stage values y + Z[:, s] as one (3 N, 3) batch,
        stage-major, as ``cs`` holds the invariants."""
        return (y[None, :, :] + Z.transpose(0, 1)).reshape(3 * n, 3)

    def by_env(x):
        """(3 N, ...) stage-major -> (N, 3, ...)."""
        return x.reshape((3, n) + x.shape[1:]).transpose(0, 1)

    def body(carry):
        t, dt, y, nacc, nrej = carry
        active = t < span
        h = torch.where(active, torch.minimum(dt, span - t), 0.0)
        h_safe = torch.where(h > 0.0, h, 1.0)  # masked envs: no 0-divides
        h3 = h[:, None, None]

        f0 = _fvec(y, c)
        Z = h3 * C3[None, :, None] * f0[:, None, :]  # Euler predictor
        for _ in range(_RADAU_NEWTON_ITERS):
            F, J_st = map(by_env, _rhs_and_jacobian(stages(y, Z), cs))
            # Exact Newton matrix: block (i, j) = delta_ij I - h a_ij J_j.
            M = eye9 - h3 * torch.einsum("ij,bjpq->bipjq", A3, J_st).reshape(n, 9, 9)
            R = Z - h3 * torch.einsum("ij,bjc->bic", A3, F)
            dZ = torch.linalg.solve(M, R.reshape(n, 9, 1))
            Z = Z - dZ.reshape(n, 3, 3)

        _, J = _rhs_and_jacobian(y, c)  # step-start Jacobian for the estimate
        y_new = y + Z[:, 2, :]  # stiffly accurate: b = last row of A

        err_rhs = f0 + torch.einsum("s,bsc->bc", E3, Z) / h_safe[:, None]
        mu_h = _rdiv(_RADAU_MU, h_safe)
        err = torch.stack(_solve3(mu_h[:, None, None] * c.consts["eye"] - J,
                                  *err_rhs.unbind(-1), tiny), dim=-1)
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        ratio = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))

        # The final Newton residual: a non-converged Newton rejects.
        F = by_env(_fvec(stages(y, Z), cs))
        R = Z - h3 * torch.einsum("ij,bjc->bic", A3, F)
        res_ratio = torch.sqrt(torch.mean((R / scale[:, None, :]) ** 2, dim=(-2, -1)))
        ratio = torch.maximum(ratio, res_ratio)
        accept, new_dt = _controller(ratio, dt, dt_min, dt_max, 0.25, 8.0)

        do = active & accept
        y_norm = flush_subnormal(torch.stack(normalize_with_fallback(*y_new.unbind(-1)), dim=-1))
        y = torch.where(do[:, None], y_norm, y)
        t = torch.where(do, t + h, t)
        nacc = nacc + do.to(torch.int32)
        nrej = nrej + (active & ~accept).to(torch.int32)
        dt = torch.where(active, new_dt, dt)
        return t, dt, y, nacc, nrej

    return body


def trajectory_energy(m_traj, params: LLGSParams, h_applied=(0.0, 0.0, 0.0)) -> Tensor:
    """Energy along a trajectory (..., 3), on the params' device."""
    m = torch.as_tensor(m_traj, device=params.volume.device)
    return energy_density(m[..., 0], m[..., 1], m[..., 2], params, h_applied) * params.volume


def trajectory_torques(m_traj, current, params: LLGSParams) -> Tensor:
    """|dm/dt| along a trajectory (..., 3), on the params' device."""
    m = torch.as_tensor(m_traj, device=params.volume.device)
    fx, fy, fz = dmdt(m[..., 0], m[..., 1], m[..., 2], current, params)
    return torch.sqrt(fx * fx + fy * fy + fz * fz)


def find_stable_states(
    params: LLGSParams,
    n_seeds: int = 64,
    relax_time: float = 5e-9,
    seed: int = 0,
    tol: float = 1e-3,
) -> np.ndarray:
    """Relaxation-based stable state search: relax ``n_seeds`` random unit
    vectors at zero current in one batched float32 RK45 solve on the
    params' device, then cluster the endpoints on the host (a new state
    unless its dot with a kept one exceeds 1 - tol).

    The seeds are normals from a CPU torch.Generator seeded with ``seed``
    (the same on every device); the JAX package draws them with
    ``jax.random``, so the two find the same states from different
    seeds."""
    device = params.volume.device
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((n_seeds, 3), generator=g, dtype=torch.float32).to(device)
    m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    res = integrate_adaptive(
        m.unbind(-1),
        torch.full((n_seeds,), relax_time, dtype=torch.float32, device=device),
        torch.zeros((n_seeds,), dtype=torch.float32, device=device),
        params.to(dtype=torch.float32),
        rtol=1e-5,
        atol=1e-8,
    )
    finals = torch.stack(res.m, dim=-1).cpu().numpy()
    states: list = []
    for v in finals:
        if not any(np.dot(v, s) > 1.0 - tol for s in states):
            states.append(v)
    return np.asarray(states)
