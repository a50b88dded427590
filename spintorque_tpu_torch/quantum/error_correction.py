"""Topological / surface-code error correction, batched on the device.

PyTorch counterpart of ``spintorque_tpu/quantum/error_correction.py``.
Error dynamics use the *Pauli-frame* picture: errors are binary vectors,
syndrome extraction is a GF(2) matrix-vector product (one float32 matmul
and a parity), and Monte-Carlo trials batch along a leading axis: a
million decode trials is a (1e6, n) @ (n, s) matmul, not a loop.

Integer products are taken in float32 (the syndromes) or as an
elementwise product and a sum (the logical overlap): CUDA torch has no
integer matmul. Both are exact for these 0/1 vectors. The codes live on
``device`` (the card unless the caller asks for "cpu"); Monte-Carlo rates
draw from a ``torch.Generator`` on it seeded with ``seed``, another stream
than the JAX package's ``jax.random``, so rates agree with it within their
binomial spread, not draw for draw.

Physics tie-in: ``TopologicalProtection`` maps a skyrmion device's
stability factor to a physical error rate via an Arrhenius law, and
``SkyrmionErrorCorrection`` evaluates how much a repetition code
suppresses the resulting logical error rate.
"""

from __future__ import annotations

from math import comb
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..constants import KB
from ..parallel.mesh import resolve_device

Tensor = torch.Tensor

__all__ = [
    "SurfaceCodeErrorCorrection",
    "SkyrmionErrorCorrection",
    "TopologicalProtection",
    "LogicalQubitOperations",
]


def _mod2_matmul(errors: Tensor, parity_t: Tensor) -> Tensor:
    """(B, n) x (n, s) GF(2) product as a float32 matmul + parity extract."""
    prod = errors.to(torch.float32) @ parity_t.to(torch.float32)
    return torch.remainder(prod, 2.0).to(torch.int32)


class SurfaceCodeErrorCorrection:
    """Distance-3 rotated surface code under independent X/Z noise.

    9 data qubits on a 3x3 grid, 4 X- and 4 Z-stabilizers, exact
    minimum-weight lookup decoding (the optimal decoder at d=3), batched
    Monte-Carlo logical-error-rate estimation.

    Grid layout (data qubit index = 3*row + col):
        0 1 2
        3 4 5
        6 7 8
    """

    DISTANCE = 3
    N_DATA = 9

    # Rotated d=3 layout: checkerboard bulk plaquettes {0,1,3,4}/{4,5,7,8}
    # (Z) and {1,2,4,5}/{3,4,6,7} (X) plus weight-2 boundary stabilizers.
    # Every X/Z pair overlaps on an even number of qubits (CSS commutation),
    # both groups have GF(2) rank 4 -> exactly one logical qubit, and the
    # minimum-weight undetected non-stabilizer error has weight 3.
    # Z-stabilizers detect X errors.
    Z_STABILIZERS = np.array(
        [
            [1, 1, 0, 1, 1, 0, 0, 0, 0],  # {0,1,3,4}
            [0, 0, 0, 0, 1, 1, 0, 1, 1],  # {4,5,7,8}
            [0, 0, 1, 0, 0, 1, 0, 0, 0],  # {2,5}
            [0, 0, 0, 1, 0, 0, 1, 0, 0],  # {3,6}
        ],
        np.int32,
    )
    # X-stabilizers detect Z errors.
    X_STABILIZERS = np.array(
        [
            [0, 1, 1, 0, 1, 1, 0, 0, 0],  # {1,2,4,5}
            [0, 0, 0, 1, 1, 0, 1, 1, 0],  # {3,4,6,7}
            [1, 1, 0, 0, 0, 0, 0, 0, 0],  # {0,1}
            [0, 0, 0, 0, 0, 0, 0, 1, 1],  # {7,8}
        ],
        np.int32,
    )
    # Logical X spans the left column (connects X-boundaries), logical Z the
    # top row; they commute with all stabilizers and overlap on qubit 0 only.
    LOGICAL_X = np.array([1, 0, 0, 1, 0, 0, 1, 0, 0], np.int32)
    LOGICAL_Z = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0], np.int32)

    def __init__(self, device=None):
        self.device = resolve_device(device, None)
        self._decode_x = self._build_decoder(self.Z_STABILIZERS)
        self._decode_z = self._build_decoder(self.X_STABILIZERS)
        t = self._tensor
        self._tables = {"x": t(self._decode_x), "z": t(self._decode_z)}
        # the parity checks transposed, and the logical operator, by error kind
        self._checks = {"x": t(self.Z_STABILIZERS.T), "z": t(self.X_STABILIZERS.T)}
        self._logical = {"x": t(self.LOGICAL_Z), "z": t(self.LOGICAL_X)}

    def _tensor(self, arr) -> Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _build_decoder(self, stabilizers: np.ndarray) -> np.ndarray:
        """Minimum-weight correction for each of the 2^s syndromes.

        Exact: enumerate all 2^9 error patterns, keep the lowest-weight
        representative per syndrome (the first of equal weight). Returns
        (2^s, n) int32 table."""
        s = stabilizers.shape[0]
        n = stabilizers.shape[1]
        table = np.full((2**s, n), -1, np.int32)
        weight = np.full((2**s,), 99, np.int32)
        for e in range(2**n):
            bits = np.array([(e >> i) & 1 for i in range(n)], np.int32)
            w = bits.sum()
            syn = (stabilizers @ bits) % 2
            key = int(np.dot(syn, 1 << np.arange(s)))
            if w < weight[key]:
                weight[key] = w
                table[key] = bits
        return table

    # -- core operations ----------------------------------------------------
    def measure_syndrome(self, errors, kind: str = "x") -> Tensor:
        """Syndromes for a (B, 9) batch of X ('x') or Z ('z') error vectors."""
        errors = torch.as_tensor(errors, device=self.device)
        return _mod2_matmul(errors, self._checks[kind])

    def decode(self, syndromes: Tensor, kind: str = "x") -> Tensor:
        """Batched lookup decode: (B, 4) syndromes -> (B, 9) corrections."""
        powers = 1 << torch.arange(syndromes.shape[-1], device=syndromes.device)
        keys = (syndromes.to(torch.int64) * powers).sum(-1)
        return self._tables[kind][keys]

    def logical_failure(self, errors, kind: str = "x") -> Tensor:
        """Whether decode(syndrome) + error anticommutes with the logical op."""
        errors = torch.as_tensor(errors, device=self.device)
        syn = self.measure_syndrome(errors, kind)
        corr = self.decode(syn, kind)
        residual = torch.remainder(errors.to(torch.int32) + corr, 2)
        # residual X error flips Z_L measurement iff overlap is odd
        overlap = torch.remainder((residual * self._logical[kind]).sum(-1), 2)
        return overlap.to(torch.bool)

    def _errors(self, generator: torch.Generator, n_trials: int, rate: float) -> Tensor:
        draws = torch.rand((n_trials, self.N_DATA), generator=generator, device=self.device)
        return (draws < rate).to(torch.int32)

    def logical_error_rate(
        self, physical_rate: float, n_trials: int = 100_000, seed: int = 0
    ) -> Dict[str, float]:
        """Monte-Carlo logical X and Z error rates at a physical rate p."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        ex = self._errors(generator, n_trials, physical_rate)
        ez = self._errors(generator, n_trials, physical_rate)
        fx = float(self.logical_failure(ex, "x").to(torch.float32).mean())
        fz = float(self.logical_failure(ez, "z").to(torch.float32).mean())
        return {
            "physical_rate": float(physical_rate),
            "logical_x_rate": fx,
            "logical_z_rate": fz,
            "suppression_factor": float(physical_rate / (fx + 1e-12)),
            "n_trials": n_trials,
        }

    def pseudo_threshold(
        self, rates: Optional[np.ndarray] = None, n_trials: int = 50_000
    ) -> float:
        """Largest p where logical rate < physical rate (d=3 pseudo-threshold)."""
        if rates is None:
            rates = np.logspace(-3, -0.7, 12)
        best = 0.0
        for p in rates:
            res = self.logical_error_rate(float(p), n_trials)
            if res["logical_x_rate"] < p:
                best = float(p)
        return best


class TopologicalProtection:
    """Arrhenius model of topologically-protected information storage.

    Maps a device's energy barrier (e.g. skyrmion stability from
    devices/skyrmion_ops.py) to a per-operation physical error rate
    p = f0 * t_op * exp(-Delta E / kT), the quantity the codes above consume.
    Host floats.
    """

    def __init__(self, attempt_frequency: float = 1e9):
        self.attempt_frequency = attempt_frequency

    def error_rate(
        self, energy_barrier: float, temperature: float, op_time: float = 1e-9
    ) -> float:
        if temperature <= 0 or energy_barrier < 0:
            return 0.0
        rate = self.attempt_frequency * np.exp(
            -energy_barrier / (KB * temperature)
        )
        return float(min(1.0, rate * op_time))

    def protection_factor(
        self, energy_barrier: float, temperature: float
    ) -> float:
        """exp(Delta/kT): how strongly the barrier suppresses thermal flips."""
        if temperature <= 0:
            return np.inf
        return float(np.exp(energy_barrier / (KB * temperature)))

    def stability_ratio(self, energy_barrier: float, temperature: float) -> float:
        """Delta = E_barrier / kT, the standard retention figure of merit."""
        if temperature <= 0:
            return np.inf
        return float(energy_barrier / (KB * temperature))


class SkyrmionErrorCorrection:
    """Repetition-coded skyrmion register with majority-vote decoding.

    A logical bit stored in ``n_copies`` skyrmion positions; thermal
    annihilation/nucleation flips copies independently with the
    TopologicalProtection rate; majority vote decodes. The trials are one
    batch on ``device`` (the card unless the caller asks for "cpu").
    """

    def __init__(self, n_copies: int = 3, protection: Optional[TopologicalProtection] = None,
                 device=None):
        if n_copies % 2 == 0:
            raise ValueError("n_copies must be odd for majority vote")
        self.n_copies = n_copies
        self.protection = protection or TopologicalProtection()
        self.device = resolve_device(device, None)

    def logical_error_rate(
        self,
        energy_barrier: float,
        temperature: float,
        op_time: float = 1e-9,
        n_trials: int = 100_000,
        seed: int = 0,
    ) -> Dict[str, float]:
        p = self.protection.error_rate(energy_barrier, temperature, op_time)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        draws = torch.rand((n_trials, self.n_copies), generator=generator, device=self.device)
        wrong = (draws < p).to(torch.int32).sum(-1) > self.n_copies // 2
        logical = float(wrong.to(torch.float32).mean())
        return {
            "physical_rate": p,
            "logical_rate": logical,
            "suppression_factor": p / (logical + 1e-18),
            "n_copies": self.n_copies,
        }

    def retention_improvement(
        self, energy_barrier: float, temperature: float, target_rate: float = 1e-9
    ) -> Dict[str, float]:
        """Retention time with vs without coding at a target error budget."""
        p = self.protection.error_rate(energy_barrier, temperature)
        if p <= 0:
            return {"uncoded_s": np.inf, "coded_s": np.inf, "gain": 1.0}
        # uncoded: p per ns; coded: ~ C(n, (n+1)/2) p^((n+1)/2)
        k = (self.n_copies + 1) // 2
        p_log = comb(self.n_copies, k) * p**k
        uncoded = target_rate / p * 1e-9
        coded = target_rate / max(p_log, 1e-300) * 1e-9
        return {"uncoded_s": uncoded, "coded_s": coded, "gain": coded / uncoded}


class LogicalQubitOperations:
    """Transversal logical operations on the d=3 surface code.

    Tracks the logical Pauli frame of a batch of encoded qubits: logical X/Z
    are bit flips of a (B, 2) frame tensor; logical CNOT acts on frame pairs.
    This is the Pauli-frame (Gottesman-Knill) picture, with O(1) cost
    instead of state vectors. The frames live on the code's device.
    """

    def __init__(self, code: Optional[SurfaceCodeErrorCorrection] = None, device=None):
        self.code = code or SurfaceCodeErrorCorrection(device)

    def init_frames(self, batch: int) -> Tensor:
        """(B, 2) int32 [x_frame, z_frame] logical Pauli frames, all |0>_L."""
        return torch.zeros((batch, 2), dtype=torch.int32, device=self.code.device)

    @staticmethod
    def _flip(frames: Tensor, col: int, by: Tensor) -> Tensor:
        out = frames.clone()
        out[:, col] = torch.remainder(frames[:, col] + by, 2)
        return out

    def logical_x(self, frames: Tensor) -> Tensor:
        return self._flip(frames, 0, 1)

    def logical_z(self, frames: Tensor) -> Tensor:
        return self._flip(frames, 1, 1)

    def logical_cnot(self, control: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        """Transversal CNOT: X propagates control->target, Z target->control."""
        new_target = self._flip(target, 0, control[:, 0])
        new_control = self._flip(control, 1, target[:, 1])
        return new_control, new_target

    def measure_logical_z(self, frames: Tensor, errors) -> Tensor:
        """Logical Z outcome including residual-error flips for a (B, 9)
        physical X-error batch."""
        fail = self.code.logical_failure(errors, "x").to(torch.int32)
        return torch.remainder(frames[:, 0] + fail, 2)
