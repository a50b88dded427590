"""Batched state-vector quantum simulation core (real-pair representation).

PyTorch counterpart of ``spintorque_tpu/quantum/statevector.py``. States
are REAL-PAIR tensors

    state: (..., 2, 2**n) float32, state[..., 0, :] = Re, [..., 1, :] = Im

and complex arithmetic is written out as real products, as the JAX
package does (its four real tensordots a gate are one real block product
here, ``apply_gate``). Gates are (..., 2, 2^k, 2^k)
real pairs; ``GATES`` keeps the plain complex NumPy matrices for host-side
algebra (circuit optimization / compilation). States are little-endian:
wire 0 is the least-significant bit of the amplitude index.

Where the JAX package vmaps a function over states, the port's functions
take leading batch dimensions: ``apply_gate`` applies a (2, 2^k, 2^k) gate
to every state of a (..., 2, 2**n) batch, or a (..., 2, 2^k, 2^k) batch of
gates (a rotation of a tensor of angles) state by state. The products
are float32 matmuls; on the card they must run in full float32 (the JAX
package asks XLA for ``Precision.HIGHEST``: reduced-precision passes lose
~3 digits a gate on the state's norm), which holds while
``torch.get_float32_matmul_precision()`` is "highest", torch's default.
``apply_gate`` raises on a card state when the process has turned TF32
(or bf16) matmuls on.

Gates built from tensors (``rx``, ``ry``, ``rz``, ``phase``, ``u3``,
``crz``) are differentiable in their angles, so variational optimizers
take exact autograd gradients. Random draws come from a
``torch.Generator`` (``sample_counts``).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from ..parallel.mesh import resolve_device

Tensor = torch.Tensor

__all__ = [
    "zero_state",
    "basis_state",
    "from_complex",
    "to_complex",
    "apply_gate",
    "apply_gate_batched",
    "expectation_pauli",
    "expectation_z",
    "probabilities",
    "sample_counts",
    "fidelity",
    "GATES",
    "gate_pair",
    "rx",
    "ry",
    "rz",
    "phase",
    "u3",
    "crz",
]

# ---------------------------------------------------------------------------
# Gate matrices (host-side complex form, for algebra and conversion)

_SQRT2 = 1.0 / math.sqrt(2.0)

GATES = {
    "I": np.eye(2, dtype=np.complex64),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex64),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex64),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex64),
    "H": np.array([[_SQRT2, _SQRT2], [_SQRT2, -_SQRT2]], dtype=np.complex64),
    "S": np.array([[1, 0], [0, 1j]], dtype=np.complex64),
    "SDG": np.array([[1, 0], [0, -1j]], dtype=np.complex64),
    "T": np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex64),
    "CNOT": np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
        dtype=np.complex64,
    ),
    "CZ": np.diag([1, 1, 1, -1]).astype(np.complex64),
    "SWAP": np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.complex64,
    ),
}


def gate_pair(mat, device=None) -> Tensor:
    """Complex (m, m) matrix -> (2, m, m) float32 real pair on ``device``
    (the card unless the caller asks for "cpu")."""
    mat = np.asarray(mat)
    pair = np.stack([mat.real, mat.imag]).astype(np.float32)
    return torch.from_numpy(pair).to(resolve_device(device, None))


def _angle(theta) -> Tensor:
    return torch.as_tensor(theta).to(torch.float32)


def _pair(re, im) -> Tensor:
    """(..., 2, m, m) real pair from the m*m (...)-shaped entries of each
    part, row by row (one stack)."""
    m = math.isqrt(len(re))
    flat = torch.stack(re + im, -1)
    return flat.reshape(flat.shape[:-1] + (2, m, m))


def rx(theta) -> Tensor:
    theta = _angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _pair([c, z, z, c], [z, -s, -s, z])


def ry(theta) -> Tensor:
    theta = _angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _pair([c, -s, s, c], [z, z, z, z])


def rz(theta) -> Tensor:
    theta = _angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _pair([c, z, z, c], [-s, z, z, s])


def phase(phi) -> Tensor:
    phi = _angle(phi)
    one, z = torch.ones_like(phi), torch.zeros_like(phi)
    return _pair([one, z, z, torch.cos(phi)], [z, z, z, torch.sin(phi)])


def u3(theta, phi, lam) -> Tensor:
    """General single-qubit rotation (OpenQASM u3 convention)."""
    theta, phi, lam = _angle(theta), _angle(phi), _angle(lam)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return _pair(
        [c, -torch.cos(lam) * s, torch.cos(phi) * s, torch.cos(phi + lam) * c],
        [torch.zeros_like(c), -torch.sin(lam) * s, torch.sin(phi) * s,
         torch.sin(phi + lam) * c],
    )


def crz(theta) -> Tensor:
    theta = _angle(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    one, z = torch.ones_like(c), torch.zeros_like(c)
    return _pair([one, z, z, z, z, one, z, z, z, z, c, z, z, z, z, c],
                 [z] * 10 + [-s, z, z, z, z, s])


# ---------------------------------------------------------------------------
# States

def basis_state(n_qubits: int, index: int, dtype=torch.float32, device=None) -> Tensor:
    """|index> as a (2, 2**n) real pair on ``device`` (the card unless the
    caller asks for "cpu")."""
    state = torch.zeros((2, 2**n_qubits), dtype=dtype, device=resolve_device(device, None))
    state[0, index] = 1.0
    return state


def zero_state(n_qubits: int, dtype=torch.float32, device=None) -> Tensor:
    return basis_state(n_qubits, 0, dtype, device)


def from_complex(arr, device=None) -> Tensor:
    """Complex (..., 2**n) array -> (..., 2, 2**n) real pair on ``device``
    (the card unless the caller asks for "cpu")."""
    arr = np.asarray(arr)
    pair = np.stack([arr.real, arr.imag], axis=-2).astype(np.float32)
    return torch.from_numpy(pair).to(resolve_device(device, None))


def to_complex(state) -> np.ndarray:
    """(..., 2, 2**n) real pair -> complex NumPy array (host-side)."""
    arr = state.detach().cpu().numpy() if isinstance(state, Tensor) else np.asarray(state)
    return arr[..., 0, :] + 1j * arr[..., 1, :]


# ---------------------------------------------------------------------------
# Gate application

def _check_full_float32(state: Tensor) -> None:
    """Raise when a product on the card would not be full float32."""
    if state.is_cuda and (torch.get_float32_matmul_precision() != "highest"
                          or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "gate products need full float32 matmuls: call "
            "torch.set_float32_matmul_precision('highest')")


def _n_qubits(state: Tensor) -> int:
    return int(round(math.log2(state.shape[-1])))


def apply_gate(state: Tensor, gate, wires: Sequence[int]) -> Tensor:
    """Apply a k-qubit gate to ``wires`` of a (..., 2, 2**n) real-pair state.

    ``gate`` is a (2, 2^k, 2^k) real pair (see ``gate_pair``), applied to
    every state of the batch, or a (..., 2, 2^k, 2^k) batch of them whose
    leading dimensions broadcast with the state's; a plain complex matrix
    is converted on the fly. The gate moves to the state's device.

    (G_r + i G_i)(psi_r + i psi_i) is the four real products of the JAX
    package, taken as one real product by the block [[G_r, -G_i], [G_i,
    G_r]] on (psi_r, psi_i): a (2^(n-k) x 2^(k+1)) @ (2^(k+1) x 2^(k+1))
    float32 matmul per state, its row and column the real/imaginary part and
    the wires' bits. The state, reshaped to (2,)*n amplitudes, has axis 0
    the MOST significant bit, so wire w lives on axis n-1-w: those axes go
    last for the product and are restored after it. One matmul where four
    would be, on the card a few launches a gate where four products and
    their sums would take ~15.
    """
    n = _n_qubits(state)
    _check_full_float32(state)
    if isinstance(gate, np.ndarray):
        gate = gate_pair(gate, state.device)
    gate = gate.to(device=state.device, dtype=state.dtype)
    k = int(gate.shape[-1]).bit_length() - 1
    gr, gi = gate[..., 0, :, :], gate[..., 1, :, :]
    block = torch.cat([torch.cat([gr, -gi], -1), torch.cat([gi, gr], -1)], -2)
    lead = state.shape[:-2]
    nb = len(lead)
    axes = [n - 1 - w for w in wires]
    others = [a for a in range(n) if a not in axes]
    x = state.reshape(lead + (2,) * (n + 1)).permute(
        list(range(nb)) + [nb + 1 + a for a in others] + [nb] + [nb + 1 + a for a in axes])
    y = torch.matmul(x.reshape(lead + (2 ** (n - k), 2 << k)), block.transpose(-1, -2))
    out_lead = y.shape[:-2]
    m = len(out_lead)
    y = y.reshape(out_lead + (2,) * (n + 1))
    # y's axes: the batch, the other wires, the real/imaginary part, the wires
    where = {a: m + i for i, a in enumerate(others)}
    where.update({a: m + n - k + 1 + i for i, a in enumerate(axes)})
    y = y.permute(list(range(m)) + [m + n - k] + [where[a] for a in range(n)])
    return y.reshape(out_lead + (2, 2**n))


def apply_gate_batched(states: Tensor, gate, wires: Sequence[int]) -> Tensor:
    """``apply_gate`` over a (B, 2, 2**n) batch of states (the JAX
    package's vmap; ``apply_gate`` itself takes the batch)."""
    return apply_gate(states, gate, wires)


# ---------------------------------------------------------------------------
# Measurement / expectation

def expectation_pauli(state: Tensor, pauli: str, coeff: float = 1.0) -> Tensor:
    """<psi| P |psi> for a Pauli string like 'ZZI' (left = highest wire),
    one value per state of a (..., 2, 2**n) batch.

    Strings are big-endian to read like ket labels: pauli[0] acts on wire
    n-1. Use 'I' for untouched wires. Result is the (real) expectation.
    """
    n = _n_qubits(state)
    if len(pauli) != n:
        raise ValueError(f"Pauli string length {len(pauli)} != {n} qubits")
    psi = state
    for i, p in enumerate(pauli):
        if p == "I":
            continue
        psi = apply_gate(psi, _fixed_pair(p, state.device), (n - 1 - i,))
    # Re<state|psi> = sr.pr + si.pi
    return coeff * ((state[..., 0, :] * psi[..., 0, :]).sum(-1)
                    + (state[..., 1, :] * psi[..., 1, :]).sum(-1))


def expectation_z(state: Tensor, wire: int) -> Tensor:
    """<Z_wire> via probability differences (no gate application needed)."""
    probs = probabilities(state)
    idx = torch.arange(state.shape[-1], device=state.device)
    signs = 1.0 - 2.0 * ((idx >> wire) & 1).to(probs.dtype)
    return (probs * signs).sum(-1)


def probabilities(state: Tensor) -> Tensor:
    return state[..., 0, :] ** 2 + state[..., 1, :] ** 2


def sample_counts(state: Tensor, generator: torch.Generator, shots: int) -> Tensor:
    """Sample measurement outcomes; returns (..., shots) basis-state indices
    drawn with ``generator`` (on the state's device)."""
    p = probabilities(state)
    p = p / p.sum(-1, keepdim=True)
    flat = p.reshape(-1, p.shape[-1])
    draws = torch.multinomial(flat, shots, replacement=True, generator=generator)
    return draws.reshape(p.shape[:-1] + (shots,))


def fidelity(a: Tensor, b: Tensor) -> Tensor:
    """|<a|b>|^2 for real-pair states (one value per state of a batch)."""
    re = (a[..., 0, :] * b[..., 0, :]).sum(-1) + (a[..., 1, :] * b[..., 1, :]).sum(-1)
    im = (a[..., 0, :] * b[..., 1, :]).sum(-1) - (a[..., 1, :] * b[..., 0, :]).sum(-1)
    return re * re + im * im


@functools.lru_cache(maxsize=None)
def _fixed_pair(name: str, device: torch.device) -> Tensor:
    """The real pair of fixed gate ``name`` on ``device``, built once per
    device: a copy from pageable host memory to the card waits for the
    card's queue, which a loop of gates must not do."""
    return gate_pair(GATES[name], device)
