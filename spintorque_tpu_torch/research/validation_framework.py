"""Reproducibility and correctness validation harnesses.

PyTorch counterpart of the classical half of
``spintorque_tpu/research/validation_framework.py`` (``ValidationCheck``
and ``ResearchValidationFramework``): executable invariants of the
simulation core (norm preservation, seed determinism, energy conservation
without damping, the integrator's convergence order, equilibrium
stability), each returning pass/fail with the measured quantity.

The checks run on ``device`` (the card unless the caller asks for "cpu")
in ``dtype``: on the card the pulses are the kernel's (K1, float32 on the
+z easy axis), on the CPU its plain version, which also takes float64. The
JAX package's checks run in its default float type: float64 under the
tests' x64, float32 on a TPU. In float32 the convergence-order check
cannot resolve RK4's error at its step sizes (its errors sit at float32's
rounding), so it reports an order below its threshold of 2.0; in float64
it passes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..parallel.mesh import resolve_device

__all__ = ["ValidationCheck", "ResearchValidationFramework"]


class ValidationCheck:
    def __init__(self, name: str, fn: Callable[[], Dict[str, Any]]):
        self.name = name
        self.fn = fn

    def run(self) -> Dict[str, Any]:
        try:
            out = self.fn()
            out.setdefault("passed", False)
            return {"name": self.name, **out}
        except Exception as exc:  # a validation harness reports, it does not crash
            return {"name": self.name, "passed": False, "error": repr(exc)}


class ResearchValidationFramework:
    """Physics/reproducibility validation of the simulation core."""

    def __init__(self, dtype=torch.float32, device=None):
        self.dtype = dtype
        self.device = resolve_device(device, None)
        self.checks: List[ValidationCheck] = []
        self._register_defaults()

    def register(self, name: str, fn: Callable[[], Dict[str, Any]]) -> None:
        self.checks.append(ValidationCheck(name, fn))

    # -- default physics checks --------------------------------------------
    def _params(self, **device_params):
        from ..physics.solver import params_from_dict

        return params_from_dict(
            device_params or dict(volume=1e-24, saturation_magnetization=800e3, damping=0.01,
                                  uniaxial_anisotropy=8e5, polarization=0.7,
                                  easy_axis=np.array([0.0, 0.0, 1.0])),
            self.dtype, device=self.device)

    def _t(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=self.dtype, device=self.device)

    def _register_defaults(self) -> None:
        self.register("norm_preservation", self._check_norm_preservation)
        self.register("seed_determinism", self._check_seed_determinism)
        self.register("zero_damping_energy", self._check_energy_conservation)
        self.register("convergence_order", self._check_convergence_order)
        self.register("equilibrium_stability", self._check_equilibrium)

    def _pulse(self, params, m0, span, current, **cfg):
        from ..physics.integrator import IntegratorConfig, integrate_pulse

        cfg = dict(dict(method="rk4", max_substeps=2048), **cfg)
        return integrate_pulse(tuple(self._t(c) for c in m0), self._t(span), self._t(current),
                               params, IntegratorConfig(**cfg))

    def _check_norm_preservation(self) -> Dict[str, Any]:
        m0 = torch.randn((64, 3), generator=torch.Generator().manual_seed(0),
                         dtype=torch.float64)
        m0 = (m0 / torch.linalg.vector_norm(m0, dim=-1, keepdim=True)).T.tolist()
        res = self._pulse(self._params(), m0, [1e-9] * 64, [1e6] * 64)
        norms = np.sqrt(sum(c.double().cpu().numpy() ** 2 for c in res.m))
        err = float(np.abs(norms - 1.0).max())
        return {"passed": err < 1e-5, "max_norm_error": err}

    def _check_seed_determinism(self) -> Dict[str, Any]:
        from ..envs import SpinTorqueEnv, SpinTorqueEnvConfig

        env = SpinTorqueEnv(batch_size=8, device=self.device, config=SpinTorqueEnvConfig(
            max_duration=1e-10, max_substeps=128))
        outs = []
        for _ in range(2):
            state, obs = env.reset(7)
            action = torch.tensor([[1e6, 5e-11]] * 8, device=self.device)
            state, ts = env.step(state, action)
            outs.append(ts.obs.cpu().numpy())
        identical = bool(np.array_equal(outs[0], outs[1]))
        return {"passed": identical, "identical": identical}

    def _check_energy_conservation(self) -> Dict[str, Any]:
        """alpha=0, J=0: precession conserves single-domain energy."""
        from ..physics.llgs import energy_density

        params = self._params(volume=1e-24, saturation_magnetization=800e3, damping=0.0,
                              uniaxial_anisotropy=8e5, easy_axis=np.array([0.0, 0.0, 1.0]))
        m0 = [[0.5], [0.0], [float(np.sqrt(1 - 0.25))]]
        res = self._pulse(params, m0, [1e-9], [0.0])
        e0 = float(energy_density(*(self._t(c[0]) for c in m0), params))
        e1 = float(energy_density(*(c[0] for c in res.m), params))
        rel = abs(e1 - e0) / (abs(e0) + 1e-30)
        return {"passed": rel < 5e-3, "relative_energy_drift": rel}

    def _check_convergence_order(self) -> Dict[str, Any]:
        """RK4 error should shrink ~16x when dt halves (order 4)."""
        params = self._params()
        # Smooth-dynamics current scale: the simplified STT coefficient
        # P*J/(Ms*V) is stiff at env-scale currents; order measurement needs
        # resolvable dynamics, not pole-snapping.
        m0 = [[0.3], [0.0], [0.954]]

        def final(max_step):
            res = self._pulse(params, m0, [1e-10], [2e-7], max_step=max_step,
                              max_substeps=1 << 14)
            return torch.stack(res.m).double().cpu().numpy().ravel()

        ref = final(1e-14)
        e1 = np.abs(final(4e-13) - ref).max()
        e2 = np.abs(final(2e-13) - ref).max()
        order = float(np.log2((e1 + 1e-16) / (e2 + 1e-16)))
        # float32 floors the achievable error; accept >= 2.0 measured order
        return {"passed": order > 2.0, "measured_order": order,
                "coarse_error": float(e1), "fine_error": float(e2)}

    def _check_equilibrium(self) -> Dict[str, Any]:
        """m aligned with easy axis, no drive: must stay put."""
        res = self._pulse(self._params(), [[0.0], [0.0], [1.0]], [1e-9], [0.0])
        m = torch.stack(res.m).double().cpu().numpy().ravel()
        drift = float(np.abs(m - np.array([0, 0, 1.0])).max())
        return {"passed": drift < 1e-6, "drift": drift}

    def run_all(self) -> Dict[str, Any]:
        results = [c.run() for c in self.checks]
        return {
            "passed": all(r["passed"] for r in results),
            "n_checks": len(results),
            "n_passed": sum(r["passed"] for r in results),
            "checks": results,
        }
