"""Quantum circuit IR, gate-level optimizer, and hardware compiler.

PyTorch counterpart of ``spintorque_tpu/quantum/circuits.py``. A circuit is
a flat op list executed by the state-vector core (``statevector.py``):

  * adjacent single-qubit gates are fused into one 2x2 gate by matmul;
  * identity-equivalent products are dropped (up to global phase);
  * parameterized gates are fusion barriers.

The compiler targets a {RZ, RX, CZ} native set on a line topology with
SWAP insertion, so compiled depth/2q-gate counts are honest hardware cost
estimates. The optimizer's and compiler's unitary algebra (fusion, ZYZ
angles) is host NumPy, as in the JAX package.

``QuantumCircuit.run`` is eager torch and differentiable in its parameter
vector. It takes a batch of states (..., 2, 2**n) and a batch of parameter
vectors (..., n_params) where the JAX package vmaps over them. A circuit
runs on its own ``device`` (the card unless the caller asks for "cpu"),
and moves a state or parameters given elsewhere there; its fixed gates'
real pairs are built once per device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from . import statevector as sv

Tensor = torch.Tensor

__all__ = ["Gate", "QuantumCircuit", "CircuitOptimizer", "HardwareCompiler"]


@dataclass(frozen=True)
class Gate:
    """One circuit operation. ``param`` is None for fixed gates, a float for
    bound rotations, or an int index into the circuit's parameter vector."""

    name: str
    wires: Tuple[int, ...]
    param: Optional[object] = None
    matrix: Optional[np.ndarray] = None  # for fused/custom gates

    @property
    def is_parameterized(self) -> bool:
        return isinstance(self.param, int)


_FIXED = set(sv.GATES)
_ROTATIONS = {"RX": sv.rx, "RY": sv.ry, "RZ": sv.rz, "PHASE": sv.phase}


def _gate_matrix(gate: Gate, params: Optional[Tensor], device) -> Tensor:
    """(..., 2, 2^k, 2^k) real-pair matrix of a gate: a batch of them when
    ``params`` is a (..., n_params) batch and the gate reads it."""
    if gate.matrix is not None:
        return sv.gate_pair(gate.matrix, device)
    if gate.name in _FIXED:
        return sv.gate_pair(sv.GATES[gate.name], device)
    if gate.name == "U3":
        return sv.u3(*gate.param)
    if gate.name in _ROTATIONS or gate.name == "CRZ":
        theta = params[..., gate.param] if gate.is_parameterized else gate.param
        return (sv.crz if gate.name == "CRZ" else _ROTATIONS[gate.name])(theta)
    raise ValueError(f"Unknown gate {gate.name}")


def _gate_matrix_complex(gate: Gate) -> np.ndarray:
    """Host-side complex matrix of a NON-parameterized gate, for the
    optimizer's and compiler's unitary algebra (never touches the device)."""
    if gate.is_parameterized:
        raise ValueError("parameterized gate has no static matrix")
    if gate.matrix is not None:
        return np.asarray(gate.matrix, np.complex64)
    if gate.name in _FIXED:
        return np.asarray(sv.GATES[gate.name])
    if gate.name in _ROTATIONS or gate.name == "CRZ":
        t = float(gate.param)
        c, s = np.cos(t / 2), np.sin(t / 2)
        if gate.name == "RX":
            return np.array([[c, -1j * s], [-1j * s, c]], np.complex64)
        if gate.name == "RY":
            return np.array([[c, -s], [s, c]], np.complex64)
        if gate.name == "RZ":
            return np.array(
                [[np.exp(-0.5j * t), 0], [0, np.exp(0.5j * t)]], np.complex64
            )
        if gate.name == "PHASE":
            return np.array([[1, 0], [0, np.exp(1j * t)]], np.complex64)
        out = np.eye(4, dtype=np.complex64)
        out[2, 2], out[3, 3] = np.exp(-0.5j * t), np.exp(0.5j * t)
        return out
    if gate.name == "U3":
        t, p, l = (float(x) for x in gate.param)
        c, s = np.cos(t / 2), np.sin(t / 2)
        return np.array(
            [[c, -np.exp(1j * l) * s],
             [np.exp(1j * p) * s, np.exp(1j * (p + l)) * c]],
            np.complex64,
        )
    raise ValueError(f"Unknown gate {gate.name}")


class QuantumCircuit:
    """Flat-list circuit executed by the state-vector core.

    ``circuit.run(params)`` returns the final state and is differentiable in
    ``params``; ``device`` is where it runs (the card unless the caller
    asks for "cpu").
    """

    def __init__(self, n_qubits: int, gates: Optional[Sequence[Gate]] = None, device=None):
        if n_qubits < 1 or n_qubits > 20:
            raise ValueError("n_qubits must be in [1, 20] for state-vector sim")
        self.n_qubits = n_qubits
        self.device = device
        self.gates: List[Gate] = list(gates or [])
        self.n_params = 1 + max(
            (g.param for g in self.gates if g.is_parameterized), default=-1
        )
        self._static: Dict[Tuple[str, int], Tensor] = {}

    # -- construction -------------------------------------------------------
    def add(self, name: str, wires, param=None, matrix=None) -> "QuantumCircuit":
        if isinstance(wires, int):
            wires = (wires,)
        wires = tuple(int(w) for w in wires)
        for w in wires:
            if not 0 <= w < self.n_qubits:
                raise ValueError(f"wire {w} out of range for {self.n_qubits} qubits")
        gate = Gate(name.upper(), wires, param, matrix)
        self.gates.append(gate)
        if gate.is_parameterized:
            self.n_params = max(self.n_params, gate.param + 1)
        return self

    def h(self, w):  # noqa: D102 - sugar
        return self.add("H", w)

    def x(self, w):
        return self.add("X", w)

    def cnot(self, c, t):
        return self.add("CNOT", (c, t))

    def cz(self, a, b):
        return self.add("CZ", (a, b))

    def rx(self, w, param):
        return self.add("RX", w, param)

    def ry(self, w, param):
        return self.add("RY", w, param)

    def rz(self, w, param):
        return self.add("RZ", w, param)

    # -- analysis -----------------------------------------------------------
    def depth(self) -> int:
        """Greedy ASAP-layered depth."""
        frontier = [0] * self.n_qubits
        for g in self.gates:
            layer = max(frontier[w] for w in g.wires) + 1
            for w in g.wires:
                frontier[w] = layer
        return max(frontier, default=0)

    def gate_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for g in self.gates:
            out[g.name] = out.get(g.name, 0) + 1
        return out

    def two_qubit_count(self) -> int:
        return sum(1 for g in self.gates if len(g.wires) == 2)

    # -- execution ----------------------------------------------------------
    def _matrix(self, i: int, gate: Gate, params, device) -> Tensor:
        """Gate i's real pair on ``device``; a gate that reads no parameter
        tensor is built and copied there once per device (a copy from
        pageable host memory to the card waits for the card's queue)."""
        if gate.is_parameterized:
            return _gate_matrix(gate, params, device)
        key = (str(device), i)
        pair = self._static.get(key)
        if pair is None:
            pair = self._static[key] = _gate_matrix(gate, None, device).to(device)
        return pair

    def run(self, params=None, state: Optional[Tensor] = None) -> Tensor:
        """Execute the circuit on ``state`` (a (..., 2, 2**n) batch; |0...0>
        when None) with the parameter vector(s) ``params`` (..., n_params),
        on the circuit's device: a state or parameters given elsewhere are
        moved there (differentiably)."""
        device = resolve_device(self.device, None)
        if state is None:
            state = sv.zero_state(self.n_qubits, device=device)
        state = state.to(device)
        if params is not None:
            params = torch.as_tensor(params, device=device)
        for i, g in enumerate(self.gates):
            state = sv.apply_gate(state, self._matrix(i, g, params, device), g.wires)
        return state

    def unitary(self, params=None) -> np.ndarray:
        """Full complex (2^n, 2^n) unitary by propagating every basis state
        as one batch (host-side NumPy result; analysis path)."""
        dim = 2**self.n_qubits
        device = resolve_device(self.device, None)
        basis = torch.zeros((dim, 2, dim), dtype=torch.float32, device=device)
        idx = torch.arange(dim, device=device)
        basis[idx, 0, idx] = 1.0
        with torch.no_grad():
            cols = self.run(params, state=basis)
        return sv.to_complex(cols).T

    def copy(self) -> "QuantumCircuit":
        return QuantumCircuit(self.n_qubits, list(self.gates), self.device)


class CircuitOptimizer:
    """Unitary-algebra circuit simplifier.

    Fusion is numeric: runs of adjacent single-qubit gates on one wire
    collapse into a single fused 2x2 gate, dropped entirely if it is
    identity up to global phase. Parameterized gates act as fusion barriers
    (their matrix is unknown until bind time).
    """

    def __init__(self, tol: float = 1e-7):
        self.tol = tol

    def _is_identity(self, mat: np.ndarray) -> bool:
        # identity up to global phase
        tr = np.trace(mat)
        if abs(tr) < 1e-12:
            return False
        phase_ = tr / abs(tr)
        return bool(np.allclose(mat, phase_ * np.eye(mat.shape[0]), atol=self.tol))

    def optimize(self, circuit: QuantumCircuit) -> QuantumCircuit:
        out: List[Gate] = []
        # pending fused single-qubit matrix per wire
        pending: Dict[int, np.ndarray] = {}

        def flush(wire: int):
            mat = pending.pop(wire, None)
            if mat is None:
                return
            if not self._is_identity(mat):
                out.append(Gate("FUSED", (wire,), None, mat.astype(np.complex64)))

        for g in circuit.gates:
            static_1q = (
                len(g.wires) == 1
                and not g.is_parameterized
                and (g.matrix is not None or g.name in _FIXED or g.name in _ROTATIONS)
            )
            if static_1q:
                mat = _gate_matrix_complex(g)
                w = g.wires[0]
                pending[w] = mat @ pending.get(w, np.eye(2, dtype=np.complex64))
            else:
                for w in g.wires:
                    flush(w)
                out.append(g)
        for w in list(pending):
            flush(w)
        return QuantumCircuit(circuit.n_qubits, out, circuit.device)

    def cancellation_report(self, before: QuantumCircuit, after: QuantumCircuit) -> Dict[str, float]:
        nb, na = len(before.gates), len(after.gates)
        return {
            "gates_before": nb,
            "gates_after": na,
            "reduction": 0.0 if nb == 0 else 1.0 - na / nb,
            "depth_before": before.depth(),
            "depth_after": after.depth(),
        }


class HardwareCompiler:
    """Lower a circuit to a native gate set on a line topology.

    Native set: RZ(any), RX(theta) (decomposed from fused/known 1q unitaries
    via ZYZ -> RZ/RX identities), CZ between adjacent wires; non-adjacent
    2-qubit gates get SWAP chains (each SWAP = 3 CZ + 1q layer, counted
    honestly in the cost report).
    """

    def __init__(self, coupling: Optional[Sequence[Tuple[int, int]]] = None):
        self.coupling = coupling  # None = line topology

    def _adjacent(self, a: int, b: int) -> bool:
        if self.coupling is None:
            return abs(a - b) == 1
        return (a, b) in self.coupling or (b, a) in self.coupling

    @staticmethod
    def _zyz(mat: np.ndarray) -> Tuple[float, float, float]:
        """ZYZ Euler angles of a 2x2 unitary (up to global phase)."""
        u = mat / np.sqrt(np.linalg.det(mat).astype(complex))
        theta = 2.0 * math.atan2(abs(u[1, 0]), abs(u[0, 0]))
        if abs(u[0, 0]) > 1e-12 and abs(u[1, 0]) > 1e-12:
            ang_sum = 2.0 * np.angle(u[1, 1])
            ang_diff = 2.0 * np.angle(u[1, 0])
            phi = (ang_sum + ang_diff) / 2.0
            lam = (ang_sum - ang_diff) / 2.0
        elif abs(u[0, 0]) <= 1e-12:
            phi = 2.0 * np.angle(u[1, 0])
            lam = 0.0
        else:
            phi = np.angle(u[1, 1]) * 2.0
            lam = 0.0
        return float(theta), float(phi), float(lam)

    def _emit_1q(self, out: List[Gate], wire: int, mat: np.ndarray):
        theta, phi, lam = self._zyz(mat)
        # U = RZ(phi) RY(theta) RZ(lam); RY(t) = RZ(pi/2) RX(t) RZ(-pi/2) as a
        # matrix product, so in application (emission) order the -pi/2 comes
        # first: [RZ(lam), RZ(-pi/2), RX(theta), RZ(pi/2), RZ(phi)].
        for name, ang in (
            ("RZ", lam),
            ("RZ", -math.pi / 2),
            ("RX", theta),
            ("RZ", math.pi / 2),
            ("RZ", phi),
        ):
            if abs(ang) > 1e-9:
                out.append(Gate(name, (wire,), float(ang)))

    def compile(self, circuit: QuantumCircuit) -> QuantumCircuit:
        out: List[Gate] = []
        H = np.asarray(sv.GATES["H"])
        for g in circuit.gates:
            if len(g.wires) == 1:
                if g.name == "RZ" or g.name == "RX":
                    out.append(g)
                elif g.is_parameterized:
                    out.append(g)  # parameterized rotations stay symbolic
                else:
                    self._emit_1q(out, g.wires[0], _gate_matrix_complex(g))
                continue
            a, b = g.wires
            path: List[Gate] = []
            # route: swap b toward a along the line
            cur = b
            while not self._adjacent(a, cur):
                step = cur - 1 if cur > a else cur + 1
                path.append(Gate("SWAP", (cur, step)))
                cur = step
            if g.name == "CZ":
                core = [Gate("CZ", (a, cur))]
            elif g.name == "CNOT":
                core = [
                    Gate("FUSED", (cur,), None, H),
                    Gate("CZ", (a, cur)),
                    Gate("FUSED", (cur,), None, H),
                ]
            elif g.name == "SWAP":
                core = [Gate("SWAP", (a, cur))]
            elif g.name == "CRZ" and not g.is_parameterized:
                # CRZ(t) = RZ(t/2) on target, CNOT, RZ(-t/2), CNOT
                half = float(g.param) / 2.0
                core = [
                    Gate("RZ", (cur,), half),
                    Gate("FUSED", (cur,), None, H),
                    Gate("CZ", (a, cur)),
                    Gate("FUSED", (cur,), None, H),
                    Gate("RZ", (cur,), -half),
                    Gate("FUSED", (cur,), None, H),
                    Gate("CZ", (a, cur)),
                    Gate("FUSED", (cur,), None, H),
                ]
            else:
                core = [g]
            expanded: List[Gate] = []
            for p in path:
                expanded.extend(self._expand_swap(p))
            out.extend(expanded)
            for c in core:
                if c.name == "SWAP":
                    out.extend(self._expand_swap(c))
                else:
                    out.append(c)
            for p in reversed(path):
                out.extend(self._expand_swap(p))
        compiled = QuantumCircuit(circuit.n_qubits, out, circuit.device)
        # clean up the 1q-gate storm the lowering produced
        return CircuitOptimizer().optimize(compiled)

    @staticmethod
    def _expand_swap(g: Gate) -> List[Gate]:
        a, b = g.wires
        H = np.asarray(sv.GATES["H"])
        seq = []
        for c, t in ((a, b), (b, a), (a, b)):
            seq += [
                Gate("FUSED", (t,), None, H),
                Gate("CZ", (c, t)),
                Gate("FUSED", (t,), None, H),
            ]
        return seq

    def cost_report(self, circuit: QuantumCircuit) -> Dict[str, float]:
        counts = circuit.gate_counts()
        n2q = circuit.two_qubit_count()
        return {
            "native_gates": len(circuit.gates),
            "two_qubit_gates": n2q,
            "depth": circuit.depth(),
            "estimated_error": 1.0 - (0.9999 ** (len(circuit.gates) - n2q)) * (0.995**n2q),
            "counts": counts,
        }
