"""Batched LLGS solver facades.

PyTorch counterpart of ``spintorque_tpu/physics/solver.py``: ``LLGSSolver``
(the fixed-step facade, with the aliases ``SimpleLLGSSolver``,
``RobustLLGSSolver`` and ``ScalableLLGSSolver``) and
``AdaptiveLLGSSolver`` (the tolerance-controlled one). ``solve`` takes one
(3,) magnetization or a (B, 3) batch and returns a dict of tensors on the
solver's device.

Devices. Both constructors take ``device`` and run on the card unless the
caller asks for the CPU. ``LLGSSolver.solve`` without a trajectory goes
through ``physics.integrator.integrate_pulse``: on the card that is the
CUDA pulse kernel (K1), and a configuration the kernel does not cover (a
dtype other than float32, an easy axis that is zero or not finite) raises
``ValueError`` there; it never falls back to the plain version. The
trajectory and the adaptive methods are plain torch on any device and
dtype.

Thermal noise is keyed by ``seed`` (the Philox stream of ``ops/philox.py``;
``convert.seed_from_key`` maps a JAX key to it) where the JAX package takes
a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import numpy as np
import torch

from .integrator import IntegratorConfig, integrate_pulse, integrate_pulse_trajectory
from .llgs import LLGSParams, normalize_with_fallback

Tensor = torch.Tensor

_DEFAULTS = dict(
    saturation_magnetization=800e3,
    damping=0.01,
    uniaxial_anisotropy=1e6,
    volume=1e-24,
    polarization=0.7,
)


def _device(device) -> torch.device:
    from ..parallel.mesh import resolve_device

    return resolve_device(device, None)


def params_from_dict(device_params: Dict[str, Any], dtype=torch.float32,
                     device=None) -> LLGSParams:
    """LLGSParams from a device_params dict, with the solver's defaults for
    missing keys, on ``device`` (the card unless the caller asks for the
    CPU). ``plus_z`` is read from the dict's easy axis on the host."""
    from ..ops.cuda_integrator import is_plus_z

    device = _device(device)
    easy_axis = np.asarray(device_params.get("easy_axis", np.array([0.0, 0.0, 1.0])), float)

    def t(x):
        return torch.as_tensor(np.asarray(x, float), dtype=dtype, device=device)

    return LLGSParams(
        **{k: t(device_params.get(k, v)) for k, v in _DEFAULTS.items()},
        easy_axis=t(easy_axis),
        plus_z=is_plus_z(easy_axis),
    )


def _normalized_trivial(m: Tensor) -> Tensor:
    """Zero-span result: the normalized initial state; a zero, NaN or
    infinite one falls back to [0, 0, 1] (shared by both facades)."""
    norm = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    ok = (norm >= 1e-12) & torch.isfinite(norm) & torch.isfinite(m).all(-1, keepdim=True)
    plus_z = torch.tensor([0.0, 0.0, 1.0], dtype=m.dtype).to(m.device)
    return torch.where(ok, m / torch.where(ok, norm, 1.0), plus_z)


def _prepare(solver, m_initial, t_span, device_params):
    """(m as (B, 3) on the solver's device, single, t_start, t_end, span)."""
    m = torch.as_tensor(
        m_initial if isinstance(m_initial, Tensor) else np.asarray(m_initial, float)
    ).to(device=solver.device, dtype=solver.dtype)
    single = m.ndim == 1
    if single:
        m = m[None, :]
    t_start, t_end = t_span
    return m, single, t_start, t_end, float(t_end) - float(t_start)


def _params(solver, device_params) -> LLGSParams:
    if isinstance(device_params, LLGSParams):
        return device_params.to(device=solver.device, dtype=solver.dtype)
    return params_from_dict(device_params, solver.dtype, solver.device)


class LLGSSolver:
    """Batched fixed-step LLGS solver.

    ``method`` is 'euler' (the default), 'rk4' or 'heun'; any other name
    becomes 'euler'. ``rtol``, ``atol`` and ``timeout`` are accepted for the
    reference's API and unused by the fixed-step methods. ``device`` is
    "cuda" unless the caller asks for "cpu".
    """

    def __init__(
        self,
        method: str = "euler",
        rtol: float = 1e-3,
        atol: float = 1e-6,
        max_step: float = 1e-12,
        max_substeps: int = 5120,
        timeout: float | None = None,
        dtype=torch.float32,
        *,
        device=None,
    ):
        method = method.lower()
        if method not in ("euler", "rk4", "heun"):
            method = "euler"
        self.method = method
        self.rtol = rtol
        self.atol = atol
        self.max_step = max_step
        self.max_substeps = max_substeps
        self.dtype = dtype
        self.device = _device(device)
        self.solve_count = 0

    def _config(self, thermal: bool, noise_mode: str) -> IntegratorConfig:
        return IntegratorConfig(
            method=self.method,
            max_step=self.max_step,
            max_substeps=self.max_substeps,
            thermal=thermal,
            noise_mode=noise_mode,
        )

    def solve(
        self,
        m_initial,
        t_span,
        device_params: Union[Dict[str, Any], LLGSParams],
        current=0.0,
        thermal_noise: bool = False,
        temperature: float = 300.0,
        seed: int = 0,
        noise_mode: str = "reference",
        return_trajectory: bool = False,
    ) -> Dict[str, Any]:
        """Solve the LLGS equation over (t_start, t_end) for one square pulse.

        ``m_initial``: (3,) or (B, 3). Returns {'m': the final (3,) or (B, 3)
        state, or with ``return_trajectory`` the (B, max_substeps + 1, 3)
        path, 'success', 'failed', 'message', 'n_steps', 'dt'}; a zero span
        returns the normalized initial state."""
        self.solve_count += 1
        m, single, t_start, t_end, span = _prepare(self, m_initial, t_span, device_params)
        if span <= 0.0:
            m_norm = _normalized_trivial(m)
            return {
                "t": torch.tensor([t_start, t_end], dtype=self.dtype).to(self.device),
                "m": m_norm[0] if single else m_norm,
                "success": True,
                "message": "Trivial solution (zero time span)",
                "n_steps": 1,
            }
        params = _params(self, device_params)
        cfg = self._config(thermal_noise, noise_mode)
        if params.plus_z is None:
            from ..ops.cuda_integrator import is_plus_z

            params = dataclasses.replace(params, plus_z=is_plus_z(params.easy_axis))
        B = m.shape[0]
        spans = torch.full((B,), span, dtype=self.dtype, device=self.device)
        currents = torch.broadcast_to(
            torch.as_tensor(current, dtype=self.dtype).to(self.device), (B,)).contiguous()
        m0 = normalize_with_fallback(m[:, 0], m[:, 1], m[:, 2])
        seed = seed if thermal_noise else None

        if return_trajectory:
            res, traj = integrate_pulse_trajectory(m0, spans, currents, params, cfg, seed,
                                                   temperature)
            traj = traj.permute(2, 0, 1)
            m_out = traj[0] if single else traj
        else:
            if self.device.type == "cuda":
                from ..ops.cuda_integrator import cuda_supported

                if not cuda_supported(params, cfg, self.dtype):
                    raise ValueError(
                        f"the CUDA pulse kernel does not cover dtype={self.dtype} with this "
                        "easy axis; solve on device='cpu' for another dtype"
                    )
            res = integrate_pulse(m0, spans, currents, params, cfg, seed, temperature)
            m_final = torch.stack(res.m, dim=-1)
            m_out = m_final[0] if single else m_final

        # Per-env failure flag: the reference's discard-on-invalid-trajectory
        # semantics (PulseResult.failed).
        any_failed = bool(res.failed.any())
        return {
            "m": m_out,
            "success": not any_failed,
            "failed": res.failed[0] if single else res.failed,
            "message": (
                "Integration completed successfully"
                if not any_failed
                else "Fallback result: magnetization has zero magnitude"
            ),
            "n_steps": res.n_substeps[0] if single else res.n_substeps,
            "dt": res.dt[0] if single else res.dt,
        }

    def get_solver_info(self) -> Dict[str, Any]:
        return {
            "method": self.method,
            "solve_count": self.solve_count,
            "max_step": self.max_step,
            "max_substeps": self.max_substeps,
            "backend": self.device.type,
        }


# The reference's public names: one batched object.
SimpleLLGSSolver = LLGSSolver
RobustLLGSSolver = LLGSSolver
ScalableLLGSSolver = LLGSSolver


class AdaptiveLLGSSolver:
    """Tolerance-controlled adaptive solver facade over
    ``physics.adaptive.integrate_adaptive``: 'RK45'/'DOP853'/'dopri5' run the
    embedded Dormand-Prince RK5(4) pair, 'Radau'/'BDF'/'LSODA' the 3-stage
    Radau IIA (order 5), 'midpoint' the order-2 implicit midpoint. The whole
    batch adapts in lockstep with per-env (t, dt). It integrates the
    adaptive solver's RHS (``llgs_solver_rhs``), which differs from the
    fixed-step one. ``device`` is "cuda" unless the caller asks for "cpu";
    any dtype runs on either (plain torch).
    """

    def __init__(
        self,
        method: str = "RK45",
        rtol: float = 1e-6,
        atol: float = 1e-9,
        max_steps: int = 100_000,
        dt_init: float = 1e-13,
        dt_min: float = 1e-16,
        dt_max: float = 1e-11,
        dtype=torch.float32,
        *,
        device=None,
    ):
        from .adaptive import _EXPLICIT_METHODS, _IMPLICIT_METHODS

        if method.lower() not in _EXPLICIT_METHODS + _IMPLICIT_METHODS:
            raise ValueError(
                f"AdaptiveLLGSSolver: unknown method {method!r}; choose one "
                f"of {_EXPLICIT_METHODS + _IMPLICIT_METHODS}"
            )
        self.method = method
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.dt_init = dt_init
        self.dt_min = dt_min
        self.dt_max = dt_max
        self.dtype = dtype
        self.device = _device(device)
        self.solve_count = 0

    def solve(
        self,
        m_initial,
        t_span,
        device_params: Union[Dict[str, Any], LLGSParams],
        current=0.0,
    ) -> Dict[str, Any]:
        """Adaptive solve over (t_start, t_end): {'m', 'success', 'n_steps',
        'n_rejected', 'message', and the loop's 'iterations' and
        'host_reads'}; a zero span returns the normalized initial state."""
        from .adaptive import integrate_adaptive

        self.solve_count += 1
        m, single, _, _, span = _prepare(self, m_initial, t_span, device_params)
        if span <= 0.0:
            m_norm = _normalized_trivial(m)
            return {
                "m": m_norm[0] if single else m_norm,
                "success": True,
                "n_steps": 0,
                "n_rejected": 0,
                "message": "Trivial solution (zero time span)",
            }
        res = integrate_adaptive(
            m.unbind(-1), span, current, _params(self, device_params),
            rtol=self.rtol, atol=self.atol, max_steps=self.max_steps,
            dt_init=self.dt_init, dt_min=self.dt_min, dt_max=self.dt_max,
            method=self.method,
        )
        m_out = torch.stack(res.m, dim=-1)
        ok = bool(res.success.all())
        return {
            "m": m_out[0] if single else m_out,
            "success": ok,
            "n_steps": res.n_steps[0] if single else res.n_steps,
            "n_rejected": res.n_rejected[0] if single else res.n_rejected,
            "message": (
                "Adaptive integration completed"
                if ok else "max_steps reached before t_end for some envs"
            ),
            "iterations": res.iterations,
            "host_reads": res.host_reads,
        }

    def get_solver_info(self) -> Dict[str, Any]:
        return {
            "method": self.method,
            "rtol": self.rtol,
            "atol": self.atol,
            "solve_count": self.solve_count,
            "backend": self.device.type,
        }
