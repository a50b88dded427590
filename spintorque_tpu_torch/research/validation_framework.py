"""Reproducibility and correctness validation harnesses.

PyTorch counterpart of ``spintorque_tpu/research/validation_framework.py``
(``ValidationCheck``, ``ResearchValidationFramework`` and
``QuantumValidationFramework``): executable invariants of the simulation
core (norm preservation, seed determinism, energy conservation without
damping, the integrator's convergence order, equilibrium stability) and of
the quantum tier (unitarity, the state's norm through a deep circuit,
autograd against the parameter-shift rule, the decoder on every single
error, the compiled circuit's equivalence), each returning pass/fail with
the measured quantity.

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

__all__ = ["ValidationCheck", "ResearchValidationFramework", "QuantumValidationFramework"]


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


class _Checks:
    """A list of named checks run together (the two frameworks below)."""

    def __init__(self, device=None):
        self.device = resolve_device(device, None)
        self.checks: List[ValidationCheck] = []
        self._register_defaults()

    def register(self, name: str, fn: Callable[[], Dict[str, Any]]) -> None:
        self.checks.append(ValidationCheck(name, fn))

    def run_all(self) -> Dict[str, Any]:
        results = [c.run() for c in self.checks]
        return {
            "passed": all(r["passed"] for r in results),
            "n_checks": len(results),
            "n_passed": sum(r["passed"] for r in results),
            "checks": results,
        }


class ResearchValidationFramework(_Checks):
    """Physics/reproducibility validation of the simulation core."""

    def __init__(self, dtype=torch.float32, device=None):
        self.dtype = dtype
        super().__init__(device)

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


class QuantumValidationFramework(_Checks):
    """Correctness invariants of the quantum tier, on ``device`` (the card
    unless the caller asks for "cpu"), in float32 as the tier runs."""

    def _register_defaults(self) -> None:
        self.register("unitarity", self._check_unitarity)
        self.register("norm_preservation", self._check_norm)
        self.register("gradient_vs_parameter_shift", self._check_gradient)
        self.register("decoder_single_errors", self._check_decoder)
        self.register("compiled_circuit_equivalence", self._check_compiler)

    def _circuit(self, n_qubits: int):
        from ..quantum.circuits import QuantumCircuit

        return QuantumCircuit(n_qubits, device=self.device)

    def _check_unitarity(self) -> Dict[str, Any]:
        rng = np.random.default_rng(0)
        circ = self._circuit(3)
        for _ in range(8):
            circ.add(rng.choice(["H", "S", "T", "X"]), int(rng.integers(3)))
        circ.cnot(0, 2)
        U = circ.unitary()
        err = float(np.abs(U.conj().T @ U - np.eye(8)).max())
        return {"passed": err < 1e-5, "max_deviation": err}

    def _check_norm(self) -> Dict[str, Any]:
        from ..quantum import statevector as sv

        rng = np.random.default_rng(1)
        circ = self._circuit(8)
        for d in range(20):
            for w in range(8):
                circ.add("RY", w, float(rng.uniform(0, np.pi)))
            for w in range(d % 2, 7, 2):
                circ.cz(w, w + 1)
        norm = float(sv.probabilities(circ.run()).sum())
        return {"passed": abs(norm - 1.0) < 1e-4, "norm": norm}

    def _check_gradient(self) -> Dict[str, Any]:
        """Autograd d<Z>/dtheta must equal the parameter-shift value."""
        from ..quantum import statevector as sv

        circ = self._circuit(2).rx(0, 0).ry(1, 1)
        circ.cnot(0, 1)

        def f(p):
            return sv.expectation_z(circ.run(p), 1)

        theta = torch.tensor([0.4, 0.9], device=self.device, requires_grad=True)
        (auto,) = torch.autograd.grad(f(theta), theta)
        auto = auto.cpu().numpy()
        shift = np.zeros(2)
        with torch.no_grad():
            for i in range(2):
                e = torch.zeros(2, device=self.device)
                e[i] = np.pi / 2
                shift[i] = 0.5 * (float(f(theta + e)) - float(f(theta - e)))
        err = float(np.abs(auto - shift).max())
        return {"passed": err < 1e-4, "max_gradient_error": err}

    def _check_decoder(self) -> Dict[str, Any]:
        from ..quantum.error_correction import SurfaceCodeErrorCorrection

        code = SurfaceCodeErrorCorrection(self.device)
        errors = torch.eye(9, dtype=torch.int32, device=self.device)
        fx = bool(code.logical_failure(errors, "x").any())
        fz = bool(code.logical_failure(errors, "z").any())
        return {"passed": not (fx or fz), "x_failures": fx, "z_failures": fz}

    def _check_compiler(self) -> Dict[str, Any]:
        from ..quantum.circuits import HardwareCompiler

        circ = self._circuit(3).h(0).cnot(0, 2).add("T", 1)
        compiled = HardwareCompiler().compile(circ)
        U1, U2 = circ.unitary(), compiled.unitary()
        ov = U1.conj().ravel() @ U2.ravel()
        ok = abs(ov) > 1e-9 and np.allclose(
            U1 * (ov / abs(ov)), U2, atol=1e-4
        )
        return {"passed": bool(ok), "overlap": float(abs(ov)) / U1.shape[0]}
