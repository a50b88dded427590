"""Hybrid quantum/classical simulation scheduling.

PyTorch counterpart of ``spintorque_tpu/quantum/hybrid_computing.py``. Both
execution paths are batch programs: a circuit task runs the state-vector
core on a batch of registers, a classical task is one pulse over a batch of
magnetizations (on the card one launch of the pulse kernel, K1), and the
scheduler's job is to pick the REPRESENTATION a task needs and batch sizes
that fit the device's memory.

``ProgrammableQuantumSimulator`` executes gate programs
(``quantum/circuits.py``) over batched registers with optional
depolarizing noise, applied in the Pauli-twirled Monte-Carlo picture: the
batch axis IS the Monte-Carlo axis, and each noisy gate draws one Pauli a
register and wire from a ``torch.Generator`` in one batched draw (another
stream than the JAX package's: noisy results agree in distribution).

Everything runs on ``device`` (the card unless the caller asks for
"cpu"); ``HybridMultiDeviceSimulator`` on its parameters' device.
``AdaptiveResourceOptimizer`` sizes state batches against that device's
memory and pads classical batches to the pulse kernel's block of 32 envs
(the JAX package: 16 GB of TPU HBM and 128-lane padding).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from ..physics.integrator import IntegratorConfig, integrate_pulse
from ..physics.llgs import LLGSParams
from ..utils.performance import ENV_BLOCK, device_memory_bytes
from . import statevector as sv
from .circuits import QuantumCircuit

Tensor = torch.Tensor

__all__ = [
    "SimulationTask",
    "AdaptiveScheduler",
    "ProgrammableQuantumSimulator",
    "HybridMultiDeviceSimulator",
    "AdaptiveResourceOptimizer",
]


@dataclass
class SimulationTask:
    """One unit of hybrid work."""

    kind: str  # 'quantum_circuit' | 'classical_llgs'
    payload: Dict[str, object]
    priority: int = 0
    cost_estimate: float = 0.0
    result: Optional[object] = None
    elapsed_s: float = 0.0


def _rows(m0) -> int:
    """The batch of a (B, 3) array or tensor of magnetizations."""
    return int(m0.shape[0]) if hasattr(m0, "shape") else len(m0)


def _pulse(m: Tensor, span, current, params: LLGSParams, config: IntegratorConfig) -> Tensor:
    """One pulse of the (B, 3) float32 magnetizations ``m`` (span and
    current broadcast over the batch): K1 on the card. Returns (B, 3)."""
    B = m.shape[0]
    span = torch.broadcast_to(torch.as_tensor(span, dtype=m.dtype, device=m.device), (B,))
    current = torch.broadcast_to(torch.as_tensor(current, dtype=m.dtype, device=m.device), (B,))
    res = integrate_pulse(tuple(m[:, c].contiguous() for c in range(3)), span.contiguous(),
                          current.contiguous(), params, config)
    return torch.stack(res.m, dim=-1)


class AdaptiveScheduler:
    """Route tasks to the quantum or classical execution path by cost model.

    Cost model (FLOP-count based, not wall-clock guessing):
      * circuit: n_gates * 2^(n_qubits+2) amplitude ops * batch
      * LLGS: n_substeps * ~250 FLOP * batch
    Tasks are sorted by priority then by cost and executed in that order.
    """

    def __init__(self, quantum_qubit_limit: int = 16, device=None):
        self.quantum_qubit_limit = quantum_qubit_limit
        self.device = resolve_device(device, None)
        self.simulator = ProgrammableQuantumSimulator(device=self.device)
        self.stats = {"quantum_tasks": 0, "classical_tasks": 0, "total_s": 0.0}

    @staticmethod
    def estimate_cost(task: SimulationTask) -> float:
        if task.kind == "quantum_circuit":
            circ: QuantumCircuit = task.payload["circuit"]
            batch = int(task.payload.get("batch", 1))
            return len(circ.gates) * (2 ** (circ.n_qubits + 2)) * batch
        if task.kind == "classical_llgs":
            batch = _rows(task.payload["m0"])
            n = int(task.payload.get("max_substeps", 1000))
            return n * 250.0 * batch
        raise ValueError(f"Unknown task kind {task.kind}")

    def submit(self, tasks: Sequence[SimulationTask]) -> List[SimulationTask]:
        for t in tasks:
            t.cost_estimate = self.estimate_cost(t)
        ordered = sorted(tasks, key=lambda t: (-t.priority, t.cost_estimate))
        t0 = time.perf_counter()
        for task in ordered:
            start = time.perf_counter()
            if task.kind == "quantum_circuit":
                circ: QuantumCircuit = task.payload["circuit"]
                if circ.n_qubits > self.quantum_qubit_limit:
                    raise ValueError(
                        f"{circ.n_qubits} qubits exceeds limit "
                        f"{self.quantum_qubit_limit}"
                    )
                params = task.payload.get("params")
                task.result = self.simulator.run(circ, params=params)
                self.stats["quantum_tasks"] += 1
            else:
                task.result = self._run_llgs(task.payload)
                self.stats["classical_tasks"] += 1
            task.elapsed_s = time.perf_counter() - start
        self.stats["total_s"] += time.perf_counter() - t0
        return list(ordered)

    def _run_llgs(self, payload: Dict[str, object]) -> Tensor:
        m0 = torch.as_tensor(payload["m0"], dtype=torch.float32, device=self.device)
        params: LLGSParams = payload["params"]
        cfg = IntegratorConfig(
            method=str(payload.get("method", "rk4")),
            max_substeps=int(payload.get("max_substeps", 2048)),
        )
        return _pulse(m0, payload.get("span", 1e-9), payload.get("current", 0.0),
                      params.to(device=self.device), cfg)

    def get_statistics(self) -> Dict[str, float]:
        return dict(self.stats)


class ProgrammableQuantumSimulator:
    """Gate-program executor over batched registers with optional noise.

    Depolarizing noise with probability p per gate is simulated by Pauli
    twirling: each Monte-Carlo branch applies a random Pauli after each
    noisy gate on each of its wires, and the batch axis IS the Monte-Carlo
    axis.
    """

    def __init__(self, noise_probability: float = 0.0, seed: int = 0, device=None):
        self.noise_probability = float(noise_probability)
        self.seed = seed
        self.device = resolve_device(device, None)

    def run(
        self,
        circuit: QuantumCircuit,
        params=None,
        batch: int = 1,
        initial_states=None,
    ) -> Tensor:
        """Execute; returns (2, 2^n) for batch=1/noiseless else (B, 2, 2^n)."""
        n = circuit.n_qubits
        if initial_states is None:
            base = sv.zero_state(n, device=self.device)
            states = base.expand((batch,) + base.shape)
        else:
            if isinstance(initial_states, Tensor):
                states = initial_states.to(self.device, torch.float32)
            elif np.iscomplexobj(initial_states):
                states = sv.from_complex(initial_states, self.device)  # complex -> real pair
            else:
                states = torch.as_tensor(np.asarray(initial_states), dtype=torch.float32,
                                         device=self.device)
            if states.dim() == 2:  # single (2, 2^n) state
                states = states[None]

        if self.noise_probability <= 0.0:
            out = circuit.run(params, state=states)
            return out[0] if (batch == 1 and initial_states is None) else out

        if params is not None:
            params = torch.as_tensor(params, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        paulis = torch.stack([sv.gate_pair(sv.GATES[p], self.device)
                              for p in ("I", "X", "Y", "Z")])
        p = self.noise_probability
        probs = torch.tensor([1 - p, p / 3, p / 3, p / 3], device=self.device)
        rows = states.shape[0]
        for i, g in enumerate(circuit.gates):
            states = sv.apply_gate(states, circuit._matrix(i, g, params, self.device), g.wires)
            for w in g.wires:
                choice = torch.multinomial(probs, rows, replacement=True, generator=generator)
                states = sv.apply_gate(states, paulis[choice], (w,))
        return states

    def expectation(
        self,
        circuit: QuantumCircuit,
        pauli: str,
        params=None,
        batch: int = 1,
    ) -> float:
        states = self.run(circuit, params=params, batch=batch)
        return float(sv.expectation_pauli(states, pauli).mean())


class HybridMultiDeviceSimulator:
    """Couple a classical device-magnetization batch to a quantum register.

    The register's <Z_i> expectations are meant to bias per-device
    effective fields (quantum feedback), and device alignments parameterize
    the next round of circuit rotations (classical feedback). As in the JAX
    package, ``step`` computes the bias and does not pass it to the pulse
    (a quirk kept: passing it would be another result). Each round is one
    circuit run and one pulse of the devices (K1 on the card), on the
    device of ``params``.
    """

    def __init__(
        self,
        params: LLGSParams,
        n_devices: int,
        coupling_strength: float = 1e3,
        method: str = "rk4",
    ):
        if n_devices > 12:
            raise ValueError("n_devices > 12 exceeds register capacity")
        self.params = params
        self.device = params.saturation_magnetization.device
        self.n_devices = n_devices
        self.coupling_strength = coupling_strength
        self.config = IntegratorConfig(method=method, max_substeps=2048)
        n = n_devices
        # encode alignments as RY angles (parameter w on wire w), entangle
        # along the chain
        self.circuit = QuantumCircuit(n, device=self.device)
        for w in range(n):
            self.circuit.ry(w, w)
        for w in range(n - 1):
            self.circuit.cz(w, w + 1)

    def step(
        self,
        m: Tensor,
        current: float,
        span: float = 1e-9,
    ) -> Tuple[Tensor, Tensor, Dict[str, float]]:
        """One hybrid round: quantum phase -> field bias -> classical pulse."""
        n = self.n_devices
        angles = torch.arccos(torch.clamp(m[:, 2], -1.0, 1.0))
        psi = self.circuit.run(angles)
        z_exp = torch.stack([sv.expectation_z(psi, w) for w in range(n)])

        # classical phase: the bias along z each device's field would take
        bias = self.coupling_strength * z_exp  # noqa: F841 - unused, as in the JAX package
        m_new = _pulse(m, span, current, self.params, self.config)
        info = {
            "mean_z_expectation": float(z_exp.mean()),
            "mean_alignment": float(m_new[:, 2].mean()),
            "entanglement_proxy": float(1.0 - z_exp.abs().mean()),
        }
        return m_new, z_exp, info

    def run(
        self, m0, currents: Sequence[float], span: float = 1e-9
    ) -> Dict[str, object]:
        m = torch.as_tensor(m0, dtype=torch.float32, device=self.device)
        history = [m.cpu().numpy()]
        infos: List[Dict[str, float]] = []
        for J in currents:
            m, _, info = self.step(m, float(J), span)
            history.append(m.cpu().numpy())
            infos.append(info)
        return {"trajectory": np.stack(history), "final": m.cpu().numpy(), "info": infos}


class AdaptiveResourceOptimizer:
    """Pick batch size / precision / path so the working set fits memory.

    State-vector feasibility (8 bytes * 2^n a state, four live copies
    during gate application) against ``hbm_bytes``, by default the memory
    of ``device`` (the card's unless the caller asks for "cpu"; the JAX
    package assumes 16 GB of TPU HBM), and classical batch padding to a
    multiple of the pulse kernel's block of 32 envs (the JAX package pads to
    TPU lanes of 128).
    """

    def __init__(self, hbm_bytes: Optional[float] = None, reserve_fraction: float = 0.2,
                 device=None):
        self.hbm_bytes = device_memory_bytes(device) if hbm_bytes is None else hbm_bytes
        self.reserve = reserve_fraction

    def max_statevector_batch(self, n_qubits: int, dtype_bytes: int = 8) -> int:
        usable = self.hbm_bytes * (1 - self.reserve)
        per_state = dtype_bytes * (2**n_qubits)
        # factor 4: live copies during gate application + workspace
        return max(1, int(usable / (4 * per_state)))

    def recommend(self, task: SimulationTask) -> Dict[str, object]:
        if task.kind == "quantum_circuit":
            circ: QuantumCircuit = task.payload["circuit"]
            batch = int(task.payload.get("batch", 1))
            cap = self.max_statevector_batch(circ.n_qubits)
            return {
                "path": "quantum",
                "batch": min(batch, cap),
                "batch_cap": cap,
                "feasible": circ.n_qubits <= 20,
                "dtype": "float32_pair",
            }
        batch = _rows(task.payload["m0"])
        padded = ((batch + ENV_BLOCK - 1) // ENV_BLOCK) * ENV_BLOCK
        return {
            "path": "classical",
            "batch": batch,
            "padded_batch": padded,
            "padding_waste": (padded - batch) / padded,
            "dtype": "float32",
        }
