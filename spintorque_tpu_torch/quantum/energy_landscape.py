"""VQE-style quantum-enhanced energy-landscape exploration.

PyTorch counterpart of ``spintorque_tpu/quantum/energy_landscape.py``. The
landscape Hamiltonian is exact and the VQE is full-batch Adam with exact
autograd gradients through the state-vector simulator (an eager loop where
the JAX package scans, with its update formula op by op).

Encoding: the single-domain energy E(theta, phi)
(``physics.energy_landscape.EnergyLandscape``) is evaluated on a
2^n_theta x 2^n_phi spherical grid in one batched call and loaded as a
DIAGONAL Hamiltonian over n_theta + n_phi qubits; the VQE ground state then
concentrates on the minimum-energy orientation. Uniaxial symmetry (energy
independent of phi) lets ``SymmetryEnhancedVQE`` drop the phi register
entirely, a real 2^n_phi-fold state-space reduction.

The VQE runs on ``device`` (the card unless the caller asks for "cpu");
the landscape on its parameters' device. Its initial angles come from a
``torch.Generator`` seeded with ``seed`` (another stream than the JAX
package's: results agree in outcome, not draw for draw).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from ..physics.energy_landscape import EnergyLandscape
from ..physics.llgs import LLGSParams
from . import statevector as sv
from .optimization import adam_descent

Tensor = torch.Tensor

__all__ = ["QuantumEnhancedEnergyLandscape", "SymmetryEnhancedVQE"]


def _hardware_efficient_ansatz(params: Tensor, n_qubits: int, n_layers: int) -> Tensor:
    """RY + ring-CZ ansatz; params shape (n_layers + 1, n_qubits)."""
    state = sv.zero_state(n_qubits, device=params.device)
    cz = sv._fixed_pair("CZ", params.device)
    for layer in range(n_layers):
        for w in range(n_qubits):
            state = sv.apply_gate(state, sv.ry(params[layer, w]), (w,))
        for w in range(n_qubits - 1):
            state = sv.apply_gate(state, cz, (w, w + 1))
    for w in range(n_qubits):
        state = sv.apply_gate(state, sv.ry(params[n_layers, w]), (w,))
    return state


def ansatz_energy(params: Tensor, diagonal: Tensor, n_layers: int) -> Tensor:
    """<psi(params)| diag |psi(params)> of the hardware-efficient ansatz."""
    n = params.shape[-1]
    psi = _hardware_efficient_ansatz(params, n, n_layers)
    return (sv.probabilities(psi) * diagonal).sum()


class SymmetryEnhancedVQE:
    """VQE for diagonal Hamiltonians with exact-gradient Adam.

    ``symmetry='uniaxial'`` means the target is phi-independent and only the
    theta register is simulated (the enhancement); ``'none'`` keeps the full
    register. Works for any diagonal cost vector, so it doubles as a generic
    grid-minimizer with a quantum ansatz.
    """

    def __init__(
        self,
        n_qubits: int,
        n_layers: int = 3,
        learning_rate: float = 0.1,
        iterations: int = 300,
        seed: int = 0,
        device=None,
    ):
        if n_qubits > 14:
            raise ValueError("n_qubits > 14 not supported by exact simulation")
        self.n_qubits = n_qubits
        self.n_layers = n_layers
        self.learning_rate = learning_rate
        self.iterations = iterations
        self.seed = seed
        self.device = resolve_device(device, None)

    def minimize_diagonal(self, diagonal) -> Dict[str, object]:
        """Find the ansatz state minimizing <psi|diag|psi>."""
        diag = torch.as_tensor(diagonal, device=self.device).to(torch.float32)
        scale = torch.clamp_min(diag.abs().max(), 1e-30)
        diag_n = diag / scale
        n, L = self.n_qubits, self.n_layers
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        params0 = 0.1 * torch.randn((L + 1, n), generator=generator, device=self.device)
        (params,), history = adam_descent(lambda p: ansatz_energy(p[0], diag_n, L), [params0],
                                          self.iterations, self.learning_rate)
        with torch.no_grad():
            probs = sv.probabilities(_hardware_efficient_ansatz(params, n, L))
        best_idx = int(torch.argmax(probs))
        energies = (history * scale).cpu().numpy()
        return {
            "optimal_params": params.cpu().numpy(),
            "energy_history": energies,
            "final_energy": float(history[-1]) * float(scale),
            "ground_state_index": best_idx,
            "ground_state_probability": float(probs[best_idx]),
            "exact_minimum": float(diag.min()),
            "exact_minimum_index": int(torch.argmin(diag)),
        }


class QuantumEnhancedEnergyLandscape:
    """Energy-landscape explorer backed by the VQE above, on the REAL
    physics energy (``physics.energy_landscape.EnergyLandscape.energy``) on
    the device of ``params``."""

    def __init__(
        self,
        params: LLGSParams,
        n_theta_qubits: int = 5,
        n_phi_qubits: int = 4,
        applied_field: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        include_demag: bool = True,
    ):
        self.landscape = EnergyLandscape(params, include_demag=include_demag)
        self.device = self.landscape.device
        self.n_theta_qubits = n_theta_qubits
        self.n_phi_qubits = n_phi_qubits
        self.applied_field = applied_field

    # -- grid Hamiltonian ---------------------------------------------------
    def _theta_grid(self) -> Tensor:
        n = 2**self.n_theta_qubits
        # cell centers, avoiding the poles' degenerate phi
        return (torch.arange(n, dtype=torch.float64, device=self.device) + 0.5) * math.pi / n

    def _phi_grid(self) -> Tensor:
        n = 2**self.n_phi_qubits
        return torch.arange(n, dtype=torch.float64, device=self.device) * 2.0 * math.pi / n

    def diagonal_hamiltonian(self, symmetry: str = "none") -> Tensor:
        """Energy of every grid orientation, one batched energy call."""
        theta = self._theta_grid()
        if symmetry == "uniaxial":
            phi = torch.zeros_like(theta)
        else:
            theta, phi = (g.reshape(-1) for g in
                          torch.meshgrid(theta, self._phi_grid(), indexing="ij"))
        m = torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                         torch.cos(theta)], dim=-1)
        return self.landscape.energy(m, self.applied_field)

    # -- exploration --------------------------------------------------------
    def find_ground_state(
        self, symmetry: str = "uniaxial", vqe: Optional[SymmetryEnhancedVQE] = None
    ) -> Dict[str, object]:
        diag = self.diagonal_hamiltonian(symmetry)
        n_qubits = (
            self.n_theta_qubits
            if symmetry == "uniaxial"
            else self.n_theta_qubits + self.n_phi_qubits
        )
        vqe = vqe or SymmetryEnhancedVQE(n_qubits, device=self.device)
        result = vqe.minimize_diagonal(diag)
        idx = result["ground_state_index"]
        theta = self._theta_grid().cpu().numpy()
        if symmetry == "uniaxial":
            t, p = float(theta[idx]), 0.0
        else:
            n_phi = 2**self.n_phi_qubits
            t = float(theta[idx // n_phi])
            p = float(self._phi_grid().cpu().numpy()[idx % n_phi])
        result.update(
            {
                "theta": t,
                "phi": p,
                "magnetization": np.array(
                    [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)]
                ),
                "symmetry": symmetry,
                "n_qubits": n_qubits,
            }
        )
        return result

    def symmetry_advantage(self) -> Dict[str, float]:
        """State-space reduction from exploiting uniaxial symmetry."""
        full = 2 ** (self.n_theta_qubits + self.n_phi_qubits)
        reduced = 2**self.n_theta_qubits
        return {
            "full_dimension": full,
            "reduced_dimension": reduced,
            "reduction_factor": full / reduced,
        }

    def compare_with_classical(self, symmetry: str = "uniaxial") -> Dict[str, object]:
        """VQE vs direct grid argmin on the same Hamiltonian."""
        diag = self.diagonal_hamiltonian(symmetry)
        vqe_res = self.find_ground_state(symmetry)
        exact = float(diag.min())
        return {
            "vqe_energy": vqe_res["final_energy"],
            "exact_energy": exact,
            "vqe_found_exact_cell": vqe_res["ground_state_index"] == int(torch.argmin(diag)),
            "relative_error": float(
                abs(vqe_res["final_energy"] - exact) / (abs(exact) + 1e-30)
            ),
        }
